"""The reference's tutorials on the port, one module each under the JAX
package's script names (``tutorials/*.py``): the same graphs, flags,
checks and printed lines, on the card unless ``--device cpu``.

  python -m moose_tpu_torch.tutorials.scientific_computing_multiple_players \
      [--samples N] [--grpc] [--device cpu]
  python -m moose_tpu_torch.tutorials.ml_inference_with_onnx [--batch N]
  python -m moose_tpu_torch.tutorials.interfacing_textual_and_cli
  python -m moose_tpu_torch.tutorials.multichip_spmd
"""
