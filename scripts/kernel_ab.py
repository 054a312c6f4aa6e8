#!/usr/bin/env python3
"""Time kernels and protocol operations of one checkout of the port on
one CUDA card, at the main path's shapes and at 2^20 elements.

    python3 scripts/kernel_ab.py [--root CHECKOUT] [--label NAME]
                                 [--part kernels|prf|horner|protocol|all]

``--root`` is the root of the checkout whose ``moose_tpu_torch`` is
timed (default: this one), so an older commit unpacked beside this one
can be timed in the same run: run parent, change, change, parent and
compare within the run.

``--part kernels``: K4 (ring_mul) and K5 (bit_decompose, msb).  Each row
holds the kernel against its plain version word for word, and gives its
median CUDA-event time for one call after a warm-up (``ms``), its time
per call over 20 calls between one pair of events (``ms_back_to_back``)
and the device time per call under torch.profiler (``device_ms``, the
summed durations of the kernels the card ran over 10 calls).  K4's
factor is materialised at the shares' shape, which every version takes,
and, where the checkout's ``ring_mul`` broadcasts it (``ring_mul_dims``
exists), also at its own shape; beside them the device time of
``spmd.mul_public`` at the logistic regression's shapes, copies
included.

``--part prf``: K7 under a given key (``threefry_words``,
``threefry_bits``, which every version has) in both stream layouts, at
the trainer's largest draw, 2^20 words, the secure dot's (2, 3, 1000,
1000) draw and the logistic regression's (3, 128, 1024) bit banks, with
``ms``, ``ms_back_to_back`` and ``device_ms`` as above.

``--part horner``: K6 at the logistic regression's (3, 1024), ring128,
14 steps at amount 62, at (3, 2^12), (3, 2^14), (3, 2^16) and (3, 2^20),
called as every version takes it (two contiguous pair slots,
``ring_kernels.horner``), with ``ms``, ``ms_back_to_back`` and
``device_ms`` as above; where the checkout's kernel has variants
(``horner_lanes`` exists), both (one lane or three an element) at every
size, the wrapper's choice first.

``--part protocol``: the protocol operations whose draws K7 groups, whose
reshare K3 fuses and whose truncation K2 runs whole, through the
checkout's own ``spmd`` and ``spmd_math`` (whatever kernels and draws it
runs for them) at the logistic regression's shapes (ring128,
fixed(24,40)): ``spmd.mul`` at (1024,) and at (64, 1024, 1) x
(1, 1024, 1), ``trunc_pr``, ``fx_mul`` (``_mul_like_trunc``
elementwise), ``fx_dot`` of the logit (1024, 101) @ (101, 1)
(``_mul_like_trunc``'s matrix branch), a bit decomposition,
``prefix_or`` over 64 bits and the 14-step Horner polynomial of the
sigmoid; and the secure dot's draws, ``share`` and ``trunc_pr`` at
(1000, 1000).  Each row holds the card's words against the same
operation on the CPU from the same session key, and gives ``ms``,
``ms_back_to_back``, ``device_ms`` as above and the kernels and copies
the card ran for one call (``device_launches``).

The last line is one JSON object with the rows and the card's name and
power limit.
"""

import argparse
import importlib.util
import json
import math
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def _chip_smoke():
    """This checkout's chip_smoke.py, by path (``--root`` may hold
    another)."""
    path = os.path.join(HERE, os.pardir, "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_ab", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def time_row(torch, cs, kernel, plain, args, **fields):
    got, want = kernel(*args), plain(*args)
    torch.cuda.synchronize()
    equal, _ = cs.word_diff(torch, got, want)
    del got, want
    return dict(
        fields, equal=equal,
        ms=cs.cuda_time_ms(torch, lambda: kernel(*args), reps=5),
        ms_back_to_back=cs.back_to_back_ms(torch, lambda: kernel(*args)),
        device_ms=cs.device_time_ms(torch, lambda: kernel(*args)),
    )


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=os.path.join(HERE, os.pardir))
    parser.add_argument("--label", default="this checkout")
    parser.add_argument("--part", default="all",
                        choices=("kernels", "prf", "horner", "protocol",
                                 "all"))
    opts = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    cs = _chip_smoke()
    sys.path.insert(0, os.path.abspath(opts.root))
    from moose_tpu_torch.native import build
    from moose_tpu_torch.native import ring_kernels as rk

    build.build_all()
    rows = []
    if opts.part in ("kernels", "all"):
        rows += kernel_rows(torch, cs, rk)
    if opts.part in ("prf", "all"):
        rows += prf_rows(torch, cs, rk)
    if opts.part in ("horner", "all"):
        rows += horner_rows(torch, cs, rk)
    if opts.part in ("protocol", "all"):
        rows += protocol_rows(torch, cs)
    smi = cs.nvidia_smi_line()
    for row in rows:
        print(json.dumps(row), flush=True)
    print(json.dumps({"label": opts.label, "card": smi, "rows": rows}))
    return 0 if all(row["equal"] for row in rows) else 1


def kernel_rows(torch, cs, rk):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED)
    rows = []
    for n, width, modes in (
        (cs.PATH_N, 128, (False, True)),
        (cs.TRAIN_ROWS, 128, (False, True)),
        (cs.TRAIN_ROWS * cs.MLP_HIDDEN, 128, (False, True)),
        (cs.BIG_N, 128, (False, True)),
        (cs.PATH_N, 64, (False,)),
    ):
        x = cs.random_words(torch, gen, (3, 2, n), width)
        n_ands = rk.adder_bank_count(width)
        banks = torch.randint(0, 2, (n_ands, 3, width, n), generator=gen,
                              dtype=torch.uint8, device="cuda")
        for msb_only in modes:
            kernel, plain = ((rk.msb, rk.msb_plain) if msb_only
                             else (rk.bit_decompose, rk.bit_decompose_plain))
            bound_ms, _ = cs.bits_bound(n, width, msb_only, n_ands)
            rows.append(time_row(
                torch, cs, kernel, plain, (*x, width, banks),
                name="bits_adder", shape=f"(3,2,{n})", width=width,
                mode="msb" if msb_only else "bit_decompose",
                bound_ms=bound_ms,
            ))
        del x, banks
        torch.cuda.empty_cache()
    own_shape = (False, True) if hasattr(rk, "ring_mul_dims") else (False,)
    for shape, const, width in (
        ((3, 2, cs.PATH_N), (), 128),
        ((3, 2, 64, cs.PATH_N), (64, 1), 128),
        ((3, 2, cs.BIG_N), (), 128),
        ((3, 2, 64, cs.PATH_N), (64, 1), 64),
        ((3, 2, cs.BIG_N), (), 64),
    ):
        a = cs.random_words(torch, gen, shape, width)
        c = cs.random_words(torch, gen, const, width)
        n = math.prod(shape)
        for own in own_shape:
            b = c if own else tuple(
                None if t is None else t.expand(shape).contiguous()
                for t in c)
            how = "own shape" if own else "materialised"
            row = time_row(
                torch, cs, rk.ring_mul, rk.ring_mul_plain, (*a, *b, width),
                name="ring_mul", shape=f"{shape} x {how} {const}",
                width=width,
                bound_ms=cs.ring_mul_bound(n, width, b[0].numel())[0],
            )
            if width == 64:
                def library():  # int64 multiplication wraps: ring64's product
                    return torch.mul(a[0], b[0])
                row["library_ms_back_to_back"] = cs.back_to_back_ms(
                    torch, library)
                row["library_device_ms"] = cs.device_time_ms(torch, library)
            rows.append(row)
    # spmd.mul_public as the path calls it, the constant at its own shape:
    # its device time whatever kernels the checkout runs for it (the
    # broadcast copies where it materialises the constant)
    from moose_tpu_torch.parallel import spmd

    for shape, const in (
        ((3, 2, cs.PATH_N, 1), ()),
        ((3, 2, 64, cs.PATH_N, 1), (64, 1, 1)),
        ((3, 2, 7, cs.PATH_N, 1), (7, 1, 1)),
    ):
        x = spmd.SpmdRep(*cs.random_words(torch, gen, shape, 128), 128)
        c = cs.random_words(torch, gen, const, 128)
        got = spmd.mul_public(x, *c)
        equal, _ = cs.word_diff(torch, (got.lo, got.hi),
                                rk.ring_mul_plain(x.lo, x.hi, *c, 128))
        rows.append(dict(
            name="mul_public", shape=f"{shape} x {const}", width=128,
            equal=equal,
            device_ms=cs.device_time_ms(
                torch, lambda: spmd.mul_public(x, *c)),
        ))
    return rows


def prf_rows(torch, cs, rk):
    rows = []
    k0, k1 = cs.SEED & 0xFFFFFFFF, 0x9E3779B9
    for layout in ("threefry", "threefry-pallas"):
        for n, bits, label in (
            (2 * 3 * cs.TRAIN_ROWS * cs.TRAIN_FEATURES, False,
             "trainer's largest draw"),
            (cs.BIG_N, False, "2^20 words"),
            (2 * 3 * cs.DOT_N * cs.DOT_N, False,
             "secure dot's (2,3,1000,1000)"),
            (3 * 128 * cs.LOGREG_ROWS, True,
             "logistic regression's bit banks"),
        ):
            kernel, plain = ((rk.threefry_bits, rk.threefry_bits_plain)
                             if bits else
                             (rk.threefry_words, rk.threefry_words_plain))
            rows.append(time_row(
                torch, cs, kernel, plain, (k0, k1, n, layout, "cuda"),
                name="threefry", shape=f"{n} {'bits' if bits else 'words'}"
                f" ({label})", mode=layout,
            ))
    return rows


def horner_rows(torch, cs, rk):
    from moose_tpu_torch.dialects.fixedpoint import P_1045, encode_const

    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED)
    steps, f, width = cs.HORNER_STEPS, cs.HORNER_F, 128
    raws = [encode_const(c, f, width) for c in reversed(P_1045[:steps + 1])]
    choose = getattr(rk, "horner_lanes", None)
    rows = []
    for n in (cs.PATH_N, 1 << 12, 1 << 14, 1 << 16, cs.BIG_N):
        x0, x1 = (cs.random_words(torch, gen, (3, n), width)
                  for _ in range(2))
        zbanks = cs.random_words(torch, gen, (steps, 3, n), width)
        tdraws = cs.random_words(torch, gen, (steps, 5, n), width)
        args = (x0, x1, width, raws, f, zbanks, tdraws)
        bound_ms, _ = cs.horner_bound(n, width, steps, f)
        variants = [None] if choose is None else (
            [choose(n)] + [v for v in (1, 3) if v != choose(n)])
        for lanes in variants:
            if lanes is not None:
                rk.horner_lanes = lambda _n, v=lanes: v
            try:
                rows.append(time_row(
                    torch, cs, rk.horner, rk.horner_plain, args,
                    name="horner", shape=f"(3,{n})", width=width,
                    steps=steps, amount=f, bound_ms=bound_ms, lanes=lanes,
                ))
            finally:
                if choose is not None:
                    rk.horner_lanes = choose
        del x0, x1, zbanks, tdraws
        torch.cuda.empty_cache()
    return rows


def protocol_rows(torch, cs):
    import numpy as np

    from moose_tpu_torch import interop
    from moose_tpu_torch.dialects.fixedpoint import P_1045
    from moose_tpu_torch.parallel import spmd, spmd_math

    master = (0x01234567, 0x89ABCDEF, 0xDEADBEEF, 0x0BADF00D)
    n, width, f = cs.PATH_N, 128, 40

    def shared(sess, device, shape, seed):
        rng = np.random.default_rng(seed)
        lo, hi = (rng.integers(0, 1 << 64, size=shape, dtype=np.uint64)
                  for _ in range(2))
        words = interop.ring_from_numpy(lo, hi, device=device)
        return spmd.share(sess, *words, width)

    def bits(sess, device):
        x = shared(sess, device, (n,), 4)
        b = spmd_math.bit_decompose(sess, x)
        return spmd_math.SpmdBits(torch.flip(b.arr[:, :, :64], dims=(2,)))

    # (label, inputs(sess, device), op(sess, inputs) -> words)
    ops = (
        ("spmd.mul (1024,)",
         lambda s, d: (shared(s, d, (n,), 1), shared(s, d, (n,), 2)),
         lambda s, a: spmd.mul(s, *a)),
        ("spmd.mul (64,1024,1) x (1,1024,1)",
         lambda s, d: (shared(s, d, (64, n, 1), 1),
                       shared(s, d, (1, n, 1), 2)),
         lambda s, a: spmd.mul(s, *a)),
        ("trunc_pr (1024,) by 40",
         lambda s, d: shared(s, d, (n,), 3),
         lambda s, a: spmd.trunc_pr(s, a, f)),
        ("fx_mul (1024,) fixed(24,40)",
         lambda s, d: (spmd.SpmdFixed(shared(s, d, (n,), 1), 24, f),
                       spmd.SpmdFixed(shared(s, d, (n,), 2), 24, f)),
         lambda s, a: spmd.fx_mul(s, *a).tensor),
        ("fx_dot (1024,101) @ (101,1) fixed(24,40)",
         lambda s, d: (spmd.SpmdFixed(shared(s, d, (n, 101), 8), 24, f),
                       spmd.SpmdFixed(shared(s, d, (101, 1), 9), 24, f)),
         lambda s, a: spmd.fx_dot(s, *a).tensor),
        ("bit_decompose (1024,)",
         lambda s, d: shared(s, d, (n,), 4),
         lambda s, a: spmd_math.bit_decompose(s, a).arr),
        ("prefix_or 64 bits of (1024,)",
         bits,
         lambda s, a: spmd_math.prefix_or(s, a, 64).arr),
        ("share (1000,1000)",
         lambda s, d: interop.ring_from_numpy(
             *(np.random.default_rng(6).integers(
                 0, 1 << 64, size=(cs.DOT_N, cs.DOT_N), dtype=np.uint64)
               for _ in range(2)), device=d),
         lambda s, a: spmd.share(s, *a, width)),
        ("trunc_pr (1000,1000) by 23",
         lambda s, d: shared(s, d, (cs.DOT_N, cs.DOT_N), 7),
         lambda s, a: spmd.trunc_pr(s, a, 23)),
        ("polynomial_eval 14 steps (1024,) fixed(2,62)",
         lambda s, d: spmd.SpmdFixed(shared(s, d, (n,), 5), 2, 62),
         lambda s, a: spmd_math.polynomial_eval(
             s, P_1045, a, min_coeff=2.0 ** -(f + 4)).tensor),
    )

    def words(out):
        if isinstance(out, torch.Tensor):
            return [out]
        return [t for t in (out.lo, out.hi) if t is not None]

    rows = []
    for label, inputs, op in ops:
        want_sess = spmd.SpmdSession(master, "cpu")
        want = words(op(want_sess, inputs(want_sess, "cpu")))
        sess = spmd.SpmdSession(master, "cuda")
        args = inputs(sess, "cuda")
        got = words(op(sess, args))
        torch.cuda.synchronize()
        equal = len(got) == len(want) and all(
            torch.equal(g.cpu(), w) for g, w in zip(got, want))

        def run():
            return op(sess, args)

        rows.append(dict(
            name=label, width=width, equal=equal,
            ms=cs.cuda_time_ms(torch, run, reps=20),
            ms_back_to_back=cs.back_to_back_ms(torch, run),
            device_ms=cs.device_time_ms(torch, run),
            device_launches=cs.device_launches(torch, run),
        ))
    return rows


if __name__ == "__main__":
    sys.exit(main())
