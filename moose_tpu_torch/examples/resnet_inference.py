"""Encrypted ResNet-style inference (north-star config from
BASELINE.json: "ONNX MLP / small ResNet encrypted inference").

A miniature residual convnet (Conv+BN+Relu+MaxPool, a residual block,
GlobalAveragePool, Gemm head, Softmax) is imported from ONNX and
evaluated under 3-party replicated secret sharing: the inputs are
secret-shared, every conv runs as an exact ring convolution (im2col and
the K1 limb matmul on the card), BatchNorm folds into public mirrored
affine constants, and only the final class probabilities are revealed.
The port's program of ``examples/resnet_inference.py``, on the card
unless ``--device cpu``.

  python -m moose_tpu_torch.examples.resnet_inference [--device cpu]
"""

import argparse

import numpy as np

import moose_tpu_torch as pm
from moose_tpu_torch import predictors
from moose_tpu_torch.examples import parse_args
from moose_tpu_torch.predictors.sklearn_export import resnet_block_onnx
from moose_tpu_torch.runtime import LocalMooseRuntime


def model():
    """The ONNX model and its float64 parameters."""
    return resnet_block_onnx(seed=7, in_ch=3, mid_ch=4, size=8,
                             n_classes=3)


def main(argv=None):
    """Print the encrypted class probabilities of 4 images; returns the
    model's parameters, the images and the probabilities."""
    parser = argparse.ArgumentParser(description=__doc__)
    args = parse_args(parser, argv)

    model_proto, params = model()
    predictor = predictors.from_onnx(model_proto.encode())
    print(f"imported: {type(predictor).__name__}")

    comp = predictor.predictor_factory(fixedpoint_dtype=pm.fixed(24, 40))
    runtime = LocalMooseRuntime(["alice", "bob", "carole"],
                                device=args.device)

    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 3, 8, 8)) * 0.5  # NCHW, like the ONNX export
    (probs,) = runtime.evaluate_computation(
        comp, arguments={"x": x}
    ).values()
    print("encrypted class probabilities:")
    print(np.round(probs, 4))
    print("rows sum to", np.round(probs.sum(axis=1), 4))
    return {"params": params, "x": x, "probs": np.asarray(probs)}


if __name__ == "__main__":
    main()
