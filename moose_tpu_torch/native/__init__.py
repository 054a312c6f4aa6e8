"""Part of the moose_tpu_torch port."""
