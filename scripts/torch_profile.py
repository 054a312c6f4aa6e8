#!/usr/bin/env python3
"""Where the time goes in the port's main path on one CUDA card.

Runs the eDSL secure dot (1000x1000 at fixed(14,23), ring128), one
ONNX LinearRegressor request, one ONNX logistic-regression request (also
from bytes: serialized, compiled by elk_compiler with the logical
passes and served by evaluate_compiled), one
ONNX multinomial logistic-regression request (10 classes, the SOFTMAX
head) and one request of BASELINE config 5's MLP (a binary sklearn
MLPClassifier, 100 -> 64 -> 32 -> 1, relu) (each 1024x100 at
fixed(24,40)), one request of config 5's small ResNet (the ONNX convnet
of sklearn_export.resnet_block_onnx, 1024 NCHW images of 3x8x8, 3
classes, at fixed(24,40)), and BASELINE config 2's correlation (the
scientific-computing tutorial at 1,000 rows, its columns loaded from
storage and its result saved there) and one request of BASELINE config
4's encrypted-input inference (AesWrapper in front of the logistic
regression, 1024x100 AES-GCM-encrypted rows) under the default threefry
PRF, one LogregSGDTrainer step (128x100 at fixed(24,40)) under
threefry-pallas, and one logistic-regression request under the
reference's aes-ctr PRF (config 4's share generation), through the
port's LocalMooseRuntime, warm, under torch.profiler; then the secure
dot and the logistic-regression request again on the per-host layout
(``layout="per-host"`` on the logical walk: one K7 launch a draw, its
seed derived on the host, so K7 launches outside any group range
there), the logistic-regression request lowered (``compiler_passes=
DEFAULT_PASSES``) and run by the physical executor, the encrypted-input
request per-host (the RepBitOps circuit), and last one training epoch on
the walk (``LogregSGDTrainer`` at chip_smoke.py phase 20's width: ten
SGD steps of 128 x 100 between ``load_shares`` and ``save_shares``, each
party's pair in its own ``CheckpointStore``; the staged pair is dropped
after each run); and prints for each:

- the host wall time of the request (median of three, without the
  profiler) and the device's busy and idle share (busy = the sum of
  kernel and copy times on the card in one profiled request; one
  stream);
- device time by layer: the PRF expansion (the groups of draws,
  ``ring_kernels.threefry_group``: the threefry kernel K7 they launch
  and the few PyTorch ops around it), the CUDA kernels K1-K6 (K2's and
  K3's two entry points apart), the fixed-point encode/decode, and everything
  else; beside them K7's own time and launches, whether every K7 launch
  came from a PRF range (one launch per range), K1's two device kernels
  (the limb split and the limb GEMM) and K5's two (the bank pack and the
  adder) apart;
- the seeds derived on the host in the request (``ring.mix_seed``
  calls; the card derives a session's seeds in K7) and, once, what one
  host derivation costs on this machine's CPU;
- under aes-ctr, the host expansions (one a group), the keystream bytes
  and the host time they took, and the device time of their copies
  (``prf_aes_ctr``); for the encrypted input, the device time of
  Decrypt's circuit (``aes_decrypt_device_ms``, inclusive of the PRF
  groups and kernels it launches, so outside the layers' sum);
- the number of kernels the card ran (PyTorch's and the port's);
- the top kernels by device time.

Run from the root of a checkout on a machine with a CUDA card:

    python3 scripts/torch_profile.py

The last line is one JSON object with these numbers and the card's name
and power limit.
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import (  # noqa: E402
    ProfilerActivity,
    profile,
    record_function,
)

import chip_smoke  # noqa: E402
import moose_tpu_torch as pm  # noqa: E402
from moose_tpu_torch.dialects import aes, ring  # noqa: E402
from moose_tpu_torch.native import ring_kernels as rk  # noqa: E402
from moose_tpu_torch.predictors import trainers  # noqa: E402
from moose_tpu_torch.runtime import LocalMooseRuntime  # noqa: E402

# (module, function, layer label) of the plain-PyTorch layers; the
# wrappers only open a profiler range, the function runs unchanged
LAYERS = (
    (rk, "threefry_group", "prf_expand"),
    (ring, "fixedpoint_encode", "fixedpoint_encode"),
    (ring, "fixedpoint_decode", "fixedpoint_decode"),
    (rk, "aes_ctr_group", "prf_aes_ctr"),
)
# ranges whose device time is reported whole, beside the layers: they
# hold other layers' ranges and kernels
INCLUSIVE = ((aes, "decrypt_stacked", "aes_decrypt"),)
# the CUDA kernels launch through ctypes, outside any PyTorch op, so the
# profiler gives their time to no range: their layers are read off the
# kernel names instead.  K7 launches inside the prf_expand ranges, one
# launch per group of draws, and its time is added to that layer.
PRF_KERNEL = "threefry_"
# torch.cuda._sleep's kernel, which opens every profiled region
PROFILER_MARKER = "spin_kernel"
KERNEL_LAYERS = (
    ("dot_cross_terms_", "K1_dot_cross_terms"),
    ("trunc_pairs_kernel", "K2_trunc_pairs"),
    # K2's kernel in older checkouts, which A/B runs profile with this
    # script copied into them
    ("trunc_combine_kernel", "K2_trunc_combine"),
    ("cross_terms_mul_kernel", "K3_cross_terms_mul"),
    ("cross_terms_reshare_kernel", "K3_cross_terms_reshare"),
    ("ring_mul_kernel", "K4_ring_mul"),
    ("bits_adder_", "K5_bits_adder"),
    ("horner_", "K6_horner"),
)
# the device kernels of one K1 call and of one K5 call
K1_STAGES = (("dot_cross_terms_split", "split"),
             ("dot_cross_terms_gemm", "gemm"))
K5_STAGES = (("bits_adder_pack", "pack"), ("bits_adder_add", "adder"))


def _wrap(mod, name, label):
    orig = getattr(mod, name)

    def ranged(*args, **kwargs):
        with record_function(label):
            return orig(*args, **kwargs)

    setattr(mod, name, ranged)


# ring.mix_seed calls, counted while a request is profiled
HOST_SEEDS = [0]


def _count_host_seeds():
    orig = ring.mix_seed

    def counted(*args, **kwargs):
        HOST_SEEDS[0] += 1
        return orig(*args, **kwargs)

    ring.mix_seed = counted
    return orig


def _host_seed_us(mix_seed, calls=2000) -> float:
    """Microseconds of one seed derivation on this host's CPU, as the
    session derived each draw's seed before K7 derived them on the
    card."""
    master = (0x01234567, 0x89ABCDEF, 0xDEADBEEF, 0x0BADF00D)
    t0 = time.perf_counter()
    for idx in range(calls):
        mix_seed(master, ring.session_nonce(idx, 0))
    return (time.perf_counter() - t0) / calls * 1e6


def _wall_ms(fn, reps=3) -> float:
    """Median host wall time of ``fn`` without the profiler."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def profile_request(fn, warm=2):
    """Device time of one warm request by layer and by kernel.  A layer's
    time is the summed duration of the kernels launched inside its range
    (the CPU-side event's inclusive device time), not the range's span on
    the card, which would count the gaps between its kernels."""
    for _ in range(warm):
        fn()
    wall_ms = _wall_ms(fn)
    HOST_SEEDS[0] = 0
    rk.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # the profiler now and then loses the first kernel of its region:
        # a marker kernel takes that place and is left out below
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    labels = {label for _, _, label in LAYERS}
    inclusive = dict.fromkeys((label for _, _, label in INCLUSIVE), 0.0)
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    layers = dict.fromkeys(sorted(labels), 0.0)
    ranges = dict.fromkeys(sorted(labels), 0)
    kernels = {}
    for evt in prof.events():
        if evt.name in inclusive:
            if evt.device_type == cpu:
                inclusive[evt.name] += evt.device_time_total / 1e3
            continue
        if evt.name in labels:
            if evt.device_type == cpu:
                layers[evt.name] += evt.device_time_total / 1e3
                ranges[evt.name] += 1
            continue
        if evt.device_type == cuda and PROFILER_MARKER not in evt.name:
            ms, count = kernels.get(evt.name, (0.0, 0))
            kernels[evt.name] = (ms + evt.device_time_total / 1e3, count + 1)
    for needle, label in KERNEL_LAYERS:
        layers[label] = sum(
            ms for name, (ms, _) in kernels.items() if needle in name
        )
    busy_ms = sum(ms for ms, _ in kernels.values())
    prf_kernel = [(ms, count) for name, (ms, count) in kernels.items()
                  if PRF_KERNEL in name]
    prf_kernel_ms = sum(ms for ms, _ in prf_kernel)
    prf_launches = sum(count for _, count in prf_kernel)
    layers["prf_expand"] += prf_kernel_ms

    def stages(table):
        return {
            stage: {
                "device_ms": sum(ms for name, (ms, _) in kernels.items()
                                 if needle in name),
                "count": sum(count for name, (_, count) in kernels.items()
                             if needle in name),
            }
            for needle, stage in table
        }

    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
    return {
        "wall_ms": wall_ms,
        "device_launches": sum(count for _, count in kernels.values()),
        "device_busy_ms": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "layers_device_ms": dict(layers, other=busy_ms - sum(layers.values())),
        "K7_threefry_device_ms": prf_kernel_ms,
        "K7_threefry_launches": prf_launches,
        "prf_ranges": ranges["prf_expand"],
        "prf_expand_holds_K7": prf_launches == ranges["prf_expand"],
        "host_seed_derivations": HOST_SEEDS[0],
        "prf_aes_ctr_host_expansions": rk.LAUNCHES["prf_aes_ctr_host"],
        "aes_ctr_keystream_bytes": rk.AES_CTR_HOST["bytes"],
        "aes_ctr_host_ms": rk.AES_CTR_HOST["ms"],
        **{f"{label}_device_ms": ms for label, ms in inclusive.items()},
        "K1_stages": stages(K1_STAGES),
        "K5_stages": stages(K5_STAGES),
        "top_kernels": [
            {"name": name[:90], "device_ms": ms, "count": count}
            for name, (ms, count) in top
        ],
    }


def _training_epoch():
    """The profile of one warm epoch of phase 20's trainer on the walk,
    from the epoch-0 checkpoint its init graph committed."""
    import tempfile

    from moose_tpu_torch.storage import FilesystemStorage
    from moose_tpu_torch.training import CheckpointStore

    ids = ["alice", "bob", "carole"]
    rows = chip_smoke.SESSION_BATCH * chip_smoke.SESSION_STEPS
    x, y = chip_smoke.training_data(np.random.default_rng(chip_smoke.SEED),
                                    rows, chip_smoke.SESSION_FEATURES)
    trainer = trainers.LogregSGDTrainer(
        n_features=chip_smoke.SESSION_FEATURES,
        learning_rate=chip_smoke.SESSION_LR,
        steps_per_epoch=chip_smoke.SESSION_STEPS,
        fixedpoint_dtype=pm.fixed(24, 40))
    with tempfile.TemporaryDirectory() as root:
        stores = {p: CheckpointStore(FilesystemStorage(
            os.path.join(root, p)), party=p) for p in ids}
        runtime = LocalMooseRuntime(ids, storage_mapping=stores,
                                    use_jit=False)
        runtime.evaluate_computation(
            trainer.init_computation(),
            {"w": np.zeros((chip_smoke.SESSION_FEATURES, 1))})
        for store in stores.values():
            store.commit(0)
        comp = trainer.epoch_computation(rows)

        def epoch():
            runtime.evaluate_computation(comp, {"x": x, "y": y})
            for store in stores.values():
                store.discard_staged()

        return profile_request(epoch, warm=1)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_profile: no CUDA device", file=sys.stderr)
        return 2
    smi = chip_smoke.nvidia_smi_line()
    print(f"card: {smi}", flush=True)
    for mod, name, label in LAYERS + INCLUSIVE:
        _wrap(mod, name, label)
    seed_us = _host_seed_us(_count_host_seeds())
    print(f"host seed derivation: {seed_us:.3f} us", flush=True)
    rng = np.random.default_rng(chip_smoke.SEED)
    runtime = LocalMooseRuntime(["alice", "bob", "carole"])
    n = chip_smoke.DOT_N
    x, y = rng.normal(size=(n, n)), rng.normal(size=(n, n))
    comp = chip_smoke.secure_dot_computation(pm)
    dot = profile_request(
        lambda: runtime.evaluate_computation(comp, {"x": x, "y": y})
    )
    print(f"secure_dot: {json.dumps(dot)}", flush=True)
    predictor = chip_smoke.linear_regressor(rng, chip_smoke.LINREG_FEATURES)
    linreg = predictor.predictor_factory()
    xr = rng.normal(size=(chip_smoke.LINREG_ROWS,
                          chip_smoke.LINREG_FEATURES))
    lin = profile_request(
        lambda: runtime.evaluate_computation(linreg, {"x": xr})
    )
    print(f"linear_regressor: {json.dumps(lin)}", flush=True)
    classifier = chip_smoke.logistic_regression(
        rng, chip_smoke.LOGREG_FEATURES
    )
    logreg = classifier.predictor_factory()
    xl = rng.normal(size=(chip_smoke.LOGREG_ROWS,
                          chip_smoke.LOGREG_FEATURES))
    logreg_profile = profile_request(
        lambda: runtime.evaluate_computation(logreg, {"x": xl})
    )
    print(f"logistic_regression: {json.dumps(logreg_profile)}", flush=True)
    from moose_tpu_torch import elk_compiler, serde
    from moose_tpu_torch.edsl import tracer

    logreg_bin = elk_compiler.compile_computation(
        serde.serialize_computation(tracer.trace(logreg)),
        chip_smoke.BYTES_PASSES)
    bytes_profile = profile_request(
        lambda: runtime.evaluate_compiled(logreg_bin, {"x": xl})
    )
    print(f"from_bytes: {json.dumps(bytes_profile)}", flush=True)
    per_host = LocalMooseRuntime(["alice", "bob", "carole"],
                                 layout="per-host", use_jit=False)
    per_host_dot = profile_request(
        lambda: per_host.evaluate_computation(comp, {"x": x, "y": y})
    )
    print(f"per_host_secure_dot: {json.dumps(per_host_dot)}", flush=True)
    per_host_logreg = profile_request(
        lambda: per_host.evaluate_computation(logreg, {"x": xl})
    )
    print(f"per_host_logistic_regression: {json.dumps(per_host_logreg)}",
          flush=True)
    from moose_tpu_torch.compilation import DEFAULT_PASSES

    lowered = LocalMooseRuntime(["alice", "bob", "carole"],
                                layout="per-host")
    lowered_logreg = profile_request(
        lambda: lowered.evaluate_computation(
            logreg, {"x": xl}, compiler_passes=DEFAULT_PASSES)
    )
    print(f"lowered_logistic_regression: {json.dumps(lowered_logreg)}",
          flush=True)
    multi = chip_smoke.multinomial_regression(rng,
                                              chip_smoke.MULTI_FEATURES)
    multi_comp = multi.predictor_factory()
    xm = rng.normal(size=(chip_smoke.MULTI_ROWS, chip_smoke.MULTI_FEATURES))
    multi_profile = profile_request(
        lambda: runtime.evaluate_computation(multi_comp, {"x": xm})
    )
    print(f"multinomial_regression: {json.dumps(multi_profile)}",
          flush=True)
    from moose_tpu_torch.predictors import from_onnx, sklearn_export

    mlp = from_onnx(sklearn_export.mlp_onnx(
        chip_smoke.mlp_model(rng, chip_smoke.MLPC_FEATURES,
                             chip_smoke.MLPC_HIDDEN),
        chip_smoke.MLPC_FEATURES, classifier=True))
    mlp_comp = mlp.predictor_factory()
    xp = rng.normal(size=(chip_smoke.MLPC_ROWS, chip_smoke.MLPC_FEATURES))
    mlp_profile = profile_request(
        lambda: runtime.evaluate_computation(mlp_comp, {"x": xp})
    )
    print(f"mlp_classifier: {json.dumps(mlp_profile)}", flush=True)
    resnet_model, _ = sklearn_export.resnet_block_onnx(
        seed=chip_smoke.SEED, in_ch=chip_smoke.RESNET_CH,
        mid_ch=chip_smoke.RESNET_MID, size=chip_smoke.RESNET_SIZE,
        n_classes=chip_smoke.RESNET_CLASSES)
    resnet_comp = from_onnx(resnet_model).predictor_factory()
    xc = rng.normal(size=(chip_smoke.RESNET_ROWS, chip_smoke.RESNET_CH,
                          chip_smoke.RESNET_SIZE,
                          chip_smoke.RESNET_SIZE)) * 0.5
    resnet_profile = profile_request(
        lambda: runtime.evaluate_computation(resnet_comp, {"x": xc})
    )
    print(f"resnet: {json.dumps(resnet_profile)}", flush=True)
    alcohol, grades = chip_smoke.correlated_columns(
        chip_smoke.CORR_SIZES[-1])
    ids = chip_smoke.CORR_IDS
    corr_runtime = LocalMooseRuntime(
        list(ids), storage_mapping={ids[0]: {"alcohol_data": alcohol},
                                    ids[1]: {"grades_data": grades}})
    corr_comp = chip_smoke.correlation_computation(pm)
    corr_profile = profile_request(
        lambda: corr_runtime.evaluate_computation(corr_comp)
    )
    print(f"correlation: {json.dumps(corr_profile)}", flush=True)
    aes_model = chip_smoke.logistic_regression(
        rng, chip_smoke.AES_FEATURES, aes=True)
    aes_comp = chip_smoke.aes_inference_computation(
        pm, aes_model, pm.fixed(*chip_smoke.AES_PRECISION))
    key, nonce = chip_smoke.aes_key_nonce()
    aes_args = {
        "aes_data": aes.encrypt_fixed_array(
            key, nonce, rng.normal(size=(chip_smoke.AES_ROWS,
                                         chip_smoke.AES_FEATURES)),
            chip_smoke.AES_PRECISION[1]),
        "aes_key": aes.bytes_to_bits_be(key),
    }
    aes_profile = profile_request(
        lambda: runtime.evaluate_computation(aes_comp, aes_args)
    )
    print(f"aes_inference: {json.dumps(aes_profile)}", flush=True)
    ring.set_prf_impl("threefry-pallas")
    try:
        trainer = trainers.LogregSGDTrainer(chip_smoke.TRAIN_FEATURES,
                                            chip_smoke.TRAIN_LR)
        xt, yt = chip_smoke.training_data(rng, chip_smoke.TRAIN_ROWS,
                                          chip_smoke.TRAIN_FEATURES)
        step = trainer.step_computation(chip_smoke.TRAIN_ROWS)
        args = {"x": xt, "y": yt,
                "w": np.zeros((chip_smoke.TRAIN_FEATURES, 1))}
        train = profile_request(
            lambda: runtime.evaluate_computation(step, args)
        )
    finally:
        ring.set_prf_impl("threefry")
    print(f"training_step: {json.dumps(train)}", flush=True)
    ring.set_prf_impl("aes-ctr")
    try:
        ctr_profile = profile_request(
            lambda: runtime.evaluate_computation(logreg, {"x": xl})
        )
    finally:
        ring.set_prf_impl("threefry")
    print(f"aes_ctr_logistic_regression: {json.dumps(ctr_profile)}",
          flush=True)
    per_host_aes = profile_request(
        lambda: per_host.evaluate_computation(aes_comp, aes_args), warm=1
    )
    print(f"per_host_aes_inference: {json.dumps(per_host_aes)}",
          flush=True)
    epoch = _training_epoch()
    print(f"training_epoch: {json.dumps(epoch)}", flush=True)
    after = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(json.dumps({"card": smi, "clocks_power_after": after,
                      "host_seed_us": seed_us,
                      "secure_dot": dot, "linear_regressor": lin,
                      "logistic_regression": logreg_profile,
                      "from_bytes": bytes_profile,
                      "per_host_secure_dot": per_host_dot,
                      "per_host_logistic_regression": per_host_logreg,
                      "lowered_logistic_regression": lowered_logreg,
                      "per_host_aes_inference": per_host_aes,
                      "multinomial_regression": multi_profile,
                      "mlp_classifier": mlp_profile,
                      "resnet": resnet_profile,
                      "correlation": corr_profile,
                      "aes_inference": aes_profile,
                      "training_step": train,
                      "training_epoch": epoch,
                      "aes_ctr_logistic_regression": ctr_profile}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
