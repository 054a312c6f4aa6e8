"""Encrypted-input inference: the client AES-GCM-encrypts its features;
the 3 compute parties decrypt *under MPC* (the plaintext never exists on
any single machine) and score an ONNX model (reference AesWrapper,
pymoose/pymoose/predictors/predictor.py:49-85).  The port's program of
``examples/aes_inference.py``, on the card unless ``--device cpu``.

  python -m moose_tpu_torch.examples.aes_inference          # one process
  python -m moose_tpu_torch.examples.aes_inference --grpc   # 3 comet
      # worker processes: the ciphertext lowers through the compile
      # pipeline and the AES circuit executes role-filtered over gRPC
"""

# no `from __future__ import annotations`: the eDSL reads the
# pm.Argument annotations of the traced function as objects
import argparse
import time

import numpy as np

import moose_tpu_torch as pm
from moose_tpu_torch.dialects import aes
from moose_tpu_torch.examples import parse_args
from moose_tpu_torch.runtime import LocalMooseRuntime

alice = pm.host_placement("alice")
bob = pm.host_placement("bob")
carole = pm.host_placement("carole")
rep = pm.replicated_placement("rep", players=[alice, bob, carole])

FIXED = pm.fixed(14, 23)
LIMIT = 5e-3


@pm.computation
def secure_score(
    aes_data: pm.Argument(placement=alice,
                          vtype=pm.AesTensorType(dtype=FIXED)),
    aes_key: pm.Argument(placement=rep, vtype=pm.AesKeyType()),
    w: pm.Argument(placement=bob, dtype=pm.float64),
):
    with rep:
        x = pm.decrypt(aes_key, aes_data)  # AES-128 evaluated on shares
    with bob:
        wf = pm.cast(w, dtype=FIXED)
    with rep:
        score = pm.sigmoid(pm.dot(x, wf))
    with carole:
        out = pm.cast(score, dtype=pm.float64)
    return out


def inputs(grpc_mode):
    """The features, the weights and the computation's arguments: the
    features AES-GCM-encrypted by the data owner."""
    rng = np.random.default_rng(1)
    shape = (1, 2) if grpc_mode else (2, 4)
    features = rng.normal(size=shape)
    w = rng.normal(size=(shape[1], 1))

    # the data owner encrypts client-side with any AES-GCM implementation
    key = bytes(range(16))
    nonce = bytes([7] * 12)
    wire = aes.encrypt_fixed_array(key, nonce, features, frac_precision=23)
    arguments = {
        "aes_data": np.asarray(wire),
        "aes_key": np.asarray(aes.bytes_to_bits_be(key)),
        "w": w,
    }
    return features, w, arguments


def run_grpc(arguments, device):
    """Three comet processes on ``device`` under ``GrpcMooseRuntime``,
    with real share masks between them (threefry); the scores."""
    from moose_tpu_torch.dialects import ring
    from moose_tpu_torch.distributed.spawn import comet_workers
    from moose_tpu_torch.runtime import GrpcMooseRuntime

    prev = ring.get_prf_impl()
    ring.set_prf_impl("threefry")
    try:
        with comet_workers(device) as endpoints:
            runtime = GrpcMooseRuntime(endpoints, device=device)
            outputs, timings = runtime.evaluate_computation(
                secure_score, arguments, timeout=900.0
            )
            (scores,) = outputs.values()
            print("per-role micros:", timings)
    finally:
        ring.set_prf_impl(prev)
    return scores


def main(argv=None):
    """Decrypt and score under MPC, locally or over gRPC; returns the
    secure and the plaintext scores."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--grpc", action="store_true",
                        help="run across 3 spawned comet workers")
    args = parse_args(parser, argv)
    features, w, arguments = inputs(args.grpc)

    if args.grpc:
        scores = run_grpc(arguments, args.device)
    else:
        # party-stacked layout: the AES-GCM circuit evaluates as bit
        # banks (dialects/aes.py StackedBitOps), each AND one K7 group
        # on the card; the first call builds the kernels and, on the
        # card, captures the plan and validates it against the eager
        # walk
        runtime = LocalMooseRuntime(
            ["alice", "bob", "carole"], layout="stacked", use_jit=True,
            device=args.device,
        )
        t0 = time.perf_counter()
        (scores,) = runtime.evaluate_computation(
            secure_score, arguments
        ).values()
        t_first = time.perf_counter() - t0
        t0 = time.perf_counter()
        (scores,) = runtime.evaluate_computation(
            secure_score, arguments
        ).values()
        print(
            f"decrypt+score: first call {t_first:.1f}s (compile), "
            f"steady {time.perf_counter() - t0:.2f}s"
        )
    plain = 1 / (1 + np.exp(-(features @ w)))
    print("secure scores:   ", np.ravel(scores))
    print("plaintext scores:", np.ravel(plain))
    gap = np.abs(scores - plain).max()
    if not gap < LIMIT:
        raise AssertionError(f"score gap {gap} >= {LIMIT}")
    print("OK")
    return scores, plain


if __name__ == "__main__":
    main()
