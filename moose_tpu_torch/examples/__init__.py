"""The reference's example programs on the port, one module each under
the JAX package's script names (``examples/*.py``): the same graphs,
flags, checks and printed lines, on the card unless ``--device cpu``.

  python -m moose_tpu_torch.examples.logistic_regression [--device cpu]
  python -m moose_tpu_torch.examples.onnx_predictor [--device cpu]
  python -m moose_tpu_torch.examples.resnet_inference [--device cpu]
  python -m moose_tpu_torch.examples.aes_inference [--grpc] [--device cpu]
"""

import argparse

from moose_tpu_torch import devices


def parse_args(parser: argparse.ArgumentParser, argv=None):
    """``parser``'s arguments with the programs' ``--device`` added: the
    card unless ``--device cpu``; without a card the default raises
    ``ConfigurationError`` here, before any work."""
    parser.add_argument("--device", default="cuda",
                        help="device of every party's tensors (default: "
                        "cuda; cpu runs the plain PyTorch path)")
    args = parser.parse_args(argv)
    devices.resolve(args.device)
    return args
