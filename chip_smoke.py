#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (moose_tpu_torch) once on one CUDA card.

Run from the root of a checkout, with no arguments, on a machine with an
NVIDIA H100:

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero):
  1. versions of torch, CUDA and nvcc, and the card's name and power
     limit as nvidia-smi reports them;
  2. build every kernel of the path from moose_tpu_torch/csrc (one nvcc
     per source, started together);
  3. hold each kernel against its plain PyTorch version on the card at
     the main path's shapes, word for word, and time both with CUDA
     events after warm-up;
  4. the eDSL secure dot: 1000x1000 @ 1000x1000 at fixed(14,23), ring128,
     through LocalMooseRuntime on the card, checked against float64
     x @ y (max abs error < 2e-4);
  5. ONNX LinearRegressor inference, 100 features at fixed(24,40): three
     requests of 1024 rows, each checked against float64 x @ coef^T + b
     (max abs error < 1e-6).
Phases 4 and 5 are the main path: the kernels' launch counters are set
to 0 just before each and read just after, and each kernel must have
launched in each.  The line before the last is the kernels' JSON record;
the last line is the device record.

Without a CUDA device, or without the moose_tpu_torch package beside
it, the script prints no result and exits with code 2.
"""

# no `from __future__ import annotations`: the eDSL reads the
# pm.Argument annotations of the traced function as objects
import json
import math
import statistics
import subprocess
import sys
import time
from types import SimpleNamespace

# published peaks of one H100 SXM (NVIDIA data sheet, dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
INT8_TENSOR_OPS_PER_S = 1979e12
CUDA_CORE_OPS_PER_S = 67e12  # float32 outside the tensor cores
# 32-bit integer operations per element of the truncation tail, counted
# from csrc/trunc_combine.cu (12 shifts, 16 adds/subs, 2 selects on one
# or two u64 words, each u64 operation two to four 32-bit ones)
TRUNC_OPS_PER_ELEM = {64: 100, 128: 200}

SEED = 20261016
DOT_N = 1000
DOT_PRECISION = (14, 23)
DOT_TOL = 2e-4
LINREG_FEATURES = 100
LINREG_ROWS = 1024
LINREG_REQUESTS = 3
LINREG_TOL = 1e-6


def log(*args):
    print(*args, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(torch, fn, warmup=1, reps=5):
    """Median milliseconds of ``fn`` on the card, timed with CUDA events
    after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_abs_word_err(torch, got, want) -> float:
    err = 0.0
    for g, w in zip(got, want):
        if w is None:
            continue
        if not torch.equal(g, w):
            err = max(err, float((g.double() - w.double()).abs().max()))
    return err


def random_words(torch, gen, shape, width):
    def draw():
        return torch.randint(
            -(1 << 63), (1 << 63) - 1, shape, generator=gen,
            dtype=torch.int64, device="cuda",
        )

    return draw(), None if width == 64 else draw()


def dot_bound(m, k, n, width):
    """Least time of the exact cross terms on an H100: bytes (4 operands
    read once, one output written once) against the centered-s8
    tensor-core limb formulation (w/8 limbs per word, the limb pairs
    below the ring modulus, two contractions, three parties)."""
    word = width // 8
    nbytes = 3 * (2 * m * k + 2 * k * n + m * n) * word
    limbs = width // 8
    pairs = limbs * (limbs + 1) // 2
    ops = 2 * 3 * pairs * 2 * m * k * n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT8_TENSOR_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes else "bytes")


def trunc_bound(n, width):
    """Least time of the truncation tail: 7 ring inputs read, 3 written
    (160 B per ring128 element) against its integer operations."""
    word = width // 8
    t_bytes = n * 10 * word / HBM_BYTES_PER_S * 1e3
    t_ops = n * TRUNC_OPS_PER_ELEM[width] / CUDA_CORE_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes else "bytes")


def compare_dot(torch, rk, ring, gen, m, k, n, width, reps):
    x0, x1 = (random_words(torch, gen, (3, m, k), width) for _ in range(2))
    y0, y1 = (random_words(torch, gen, (3, k, n), width) for _ in range(2))
    ys = ring.add(*y0, *y1)
    got = rk.dot_cross_terms(x0, x1, y0, ys, width)
    want = rk.dot_cross_terms_plain(x0, x1, y0, ys, width)
    torch.cuda.synchronize()
    err = max_abs_word_err(torch, got, want)
    bound_ms, bound_by = dot_bound(m, k, n, width)
    return {
        "shape": f"(3,{m},{k})@(3,{k},{n})", "width": width,
        "equal": err == 0.0, "max_abs_err": err,
        "ms": cuda_time_ms(
            torch, lambda: rk.dot_cross_terms(x0, x1, y0, ys, width),
            reps=reps),
        "plain_ms": cuda_time_ms(
            torch, lambda: rk.dot_cross_terms_plain(x0, x1, y0, ys, width),
            reps=reps),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }


def compare_trunc(torch, rk, gen, shape, width, amount, reps):
    ins = [random_words(torch, gen, shape, width) for _ in range(7)]
    a0, a1, *draws = ins
    draws = tuple(draws)
    got = rk.trunc_combine(a0, a1, draws, width, amount)
    want = rk.trunc_combine_plain(a0, a1, draws, width, amount)
    torch.cuda.synchronize()
    err = max_abs_word_err(torch, got, want)
    bound_ms, bound_by = trunc_bound(math.prod(shape), width)
    return {
        "shape": str(tuple(shape)), "width": width, "amount": amount,
        "equal": err == 0.0, "max_abs_err": err,
        "ms": cuda_time_ms(
            torch, lambda: rk.trunc_combine(a0, a1, draws, width, amount),
            reps=reps),
        "plain_ms": cuda_time_ms(
            torch,
            lambda: rk.trunc_combine_plain(a0, a1, draws, width, amount),
            reps=reps),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }


def secure_dot_computation(pm, precision=DOT_PRECISION):
    """x on alice and y on bob, cast to fixed point, multiplied under the
    replicated placement, revealed to carole.  ``pm`` is the eDSL module
    (the port's; the tests also trace it with the JAX package's)."""
    alice = pm.host_placement("alice")
    bob = pm.host_placement("bob")
    carole = pm.host_placement("carole")
    rep = pm.replicated_placement("rep", players=[alice, bob, carole])
    fx = pm.fixed(*precision)

    @pm.computation
    def secure_dot(x: pm.Argument(alice, dtype=pm.float64),
                   y: pm.Argument(bob, dtype=pm.float64)):
        with alice:
            xf = pm.cast(x, dtype=fx)
        with bob:
            yf = pm.cast(y, dtype=fx)
        with rep:
            z = pm.dot(xf, yf)
        with carole:
            out = pm.cast(z, dtype=pm.float64)
        return out

    return secure_dot


def linear_regressor(rng, n_features):
    """The port's LinearRegressor with random weights from ``rng``, built
    as a user would: an skl2onnx-style ONNX model (weights rounded to
    float32, as ONNX stores them) through ``predictors.from_onnx``."""
    import numpy as np

    from moose_tpu_torch.predictors import from_onnx, sklearn_export

    coef = rng.normal(size=(1, n_features)).astype(np.float32)
    intercept = rng.normal(size=(1,)).astype(np.float32)
    model = sklearn_export.linear_regressor_onnx(
        SimpleNamespace(coef_=coef.astype(np.float64),
                        intercept_=intercept.astype(np.float64)),
        n_features,
    )
    return from_onnx(model)


def timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    try:
        import moose_tpu_torch as pm
        from moose_tpu_torch.dialects import ring
        from moose_tpu_torch.native import build
        from moose_tpu_torch.native import ring_kernels as rk
        from moose_tpu_torch.runtime import LocalMooseRuntime
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})",
              file=sys.stderr)
        return 2
    import numpy as np

    # phase 1: versions and the card
    nvcc = build.nvcc_path()
    nvcc_version = subprocess.run(
        [nvcc, "--version"], capture_output=True, text=True, check=True,
        timeout=60,
    ).stdout.strip().splitlines()[-1]
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} nvcc {nvcc_version}")
    smi = nvidia_smi_line()
    log(f"card: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False

    # phase 2: build
    build_s = build.build_all()
    log(f"build: {len(build.KERNELS)} kernels in {build_s:.2f} s")
    for name, text in build.BUILD_LOGS.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    # phase 3: each kernel against its plain version on the card
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    dot_rows = [
        compare_dot(torch, rk, ring, gen, DOT_N, DOT_N, DOT_N, 128, reps=5),
        compare_dot(torch, rk, ring, gen, LINREG_ROWS, LINREG_FEATURES + 1,
                    1, 128, reps=20),
        compare_dot(torch, rk, ring, gen, DOT_N, DOT_N, DOT_N, 64, reps=5),
        compare_dot(torch, rk, ring, gen, 5, 7, 3, 128, reps=20),
        compare_dot(torch, rk, ring, gen, 5, 7, 3, 64, reps=20),
    ]
    trunc_rows = [
        compare_trunc(torch, rk, gen, (DOT_N, DOT_N), 128, DOT_PRECISION[1],
                      reps=20),
        compare_trunc(torch, rk, gen, (LINREG_ROWS, 1), 128, 40, reps=20),
        compare_trunc(torch, rk, gen, (DOT_N, DOT_N), 64, DOT_PRECISION[1],
                      reps=20),
    ]
    for row in dot_rows + trunc_rows:
        log(f"compare: {json.dumps(row)}")
        if not row["equal"]:
            raise AssertionError(f"kernel disagrees with plain: {row}")

    # phase 4: the eDSL secure dot through the runtime (main path)
    rng = np.random.default_rng(SEED)
    x = rng.normal(size=(DOT_N, DOT_N))
    y = rng.normal(size=(DOT_N, DOT_N))
    runtime = LocalMooseRuntime(["alice", "bob", "carole"])
    comp = secure_dot_computation(pm)
    rk.reset_launches()
    out, dot_s = timed(
        torch, lambda: runtime.evaluate_computation(comp, {"x": x, "y": y})
    )
    dot_launches = dict(rk.LAUNCHES)
    z = out["output_0"]
    dot_err = float(np.abs(z - x @ y).max())
    log(f"secure_dot: {DOT_N}x{DOT_N} fixed{DOT_PRECISION} ring128 "
        f"latency {dot_s * 1e3:.3f} ms max_abs_err {dot_err:.3e} "
        f"launches {dot_launches}")
    if z.shape != (DOT_N, DOT_N) or not np.all(np.isfinite(z)):
        raise AssertionError(f"secure dot output malformed: {z.shape}")
    if dot_err >= DOT_TOL:
        raise AssertionError(f"secure dot error {dot_err} >= {DOT_TOL}")
    warm = [
        timed(torch, lambda: runtime.evaluate_computation(
            comp, {"x": x, "y": y}))[1]
        for _ in range(3)
    ]
    log(f"secure_dot: warm latency median "
        f"{statistics.median(warm) * 1e3:.3f} ms over {len(warm)} runs")

    # phase 5: ONNX LinearRegressor, three requests (main path)
    predictor = linear_regressor(rng, LINREG_FEATURES)
    linreg = predictor.predictor_factory()
    requests = [
        rng.normal(size=(LINREG_ROWS, LINREG_FEATURES))
        for _ in range(LINREG_REQUESTS)
    ]
    rk.reset_launches()
    latencies, linreg_errs = [], []
    for xr in requests:
        out, s = timed(
            torch, lambda: runtime.evaluate_computation(linreg, {"x": xr})
        )
        pred = out["output_0"]
        want = xr @ predictor.coeffs.T + predictor.intercepts
        if pred.shape != want.shape or not np.all(np.isfinite(pred)):
            raise AssertionError(f"prediction malformed: {pred.shape}")
        linreg_errs.append(float(np.abs(pred - want).max()))
        latencies.append(s)
    linreg_launches = dict(rk.LAUNCHES)
    rows_per_s = LINREG_ROWS * LINREG_REQUESTS / sum(latencies)
    log(f"linear_regressor: {LINREG_REQUESTS} requests of {LINREG_ROWS}x"
        f"{LINREG_FEATURES} fixed(24, 40) latencies_ms "
        f"{[round(s * 1e3, 3) for s in latencies]} rows_per_s "
        f"{rows_per_s:.1f} max_abs_err {max(linreg_errs):.3e} "
        f"launches {linreg_launches}")
    if max(linreg_errs) >= LINREG_TOL:
        raise AssertionError(
            f"linear regressor error {max(linreg_errs)} >= {LINREG_TOL}"
        )
    for path, counts in (("secure_dot", dot_launches),
                         ("linear_regressor", linreg_launches)):
        for name, n in counts.items():
            if n < 1:
                raise AssertionError(f"{path} never launched {name}")

    for mod in sys.modules:
        if mod == "jax" or mod.startswith(("jax.", "moose_tpu.")) \
                or mod == "moose_tpu":
            raise AssertionError(f"the port loaded {mod}")

    replaces = {
        "dot_cross_terms": "moose_tpu/native/ring128_kernels.py:1037",
        "trunc_combine": "moose_tpu/native/ring128_kernels.py:589",
    }
    kernels = []
    for name, rows in (("dot_cross_terms", dot_rows),
                       ("trunc_combine", trunc_rows)):
        head = rows[0]  # the secure dot's shape
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"moose_tpu_torch/csrc/{name}.cu",
            "replaces": replaces[name],
            "launches": dot_launches[name] + linreg_launches[name],
            "launches_by_path": {
                "secure_dot": dot_launches[name],
                "linear_regressor": linreg_launches[name],
            },
            "equal": all(r["equal"] for r in rows),
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "tolerance": "exact word equality",
            "shape": head["shape"],
            "ms": head["ms"],
            "kernel_ms": head["ms"],
            "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"],
            "library_ms": None,
            "shapes": rows,
        })
    record = {
        "card": smi,
        "build_s": build_s,
        "secure_dot": {"latency_ms": dot_s * 1e3,
                       "warm_latency_ms": [s * 1e3 for s in warm],
                       "max_abs_err": dot_err},
        "linear_regressor": {"latency_ms": [s * 1e3 for s in latencies],
                             "rows_per_s": rows_per_s,
                             "max_abs_err": max(linreg_errs)},
    }
    log(json.dumps(record))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
