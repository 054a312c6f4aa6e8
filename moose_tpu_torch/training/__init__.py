"""Secure training as a first-class workload: the port's
``moose_tpu/training``.

- :mod:`.checkpoint`: each party durably persists its own replicated
  share pair of the model state (atomic writes, checksum-validated
  manifests, CURRENT-pointer generations, bounded retention).  The model
  never exists in the clear on any host or at the client.
- :mod:`.session`: the epoch supervisor: runs N epochs as successive
  sessions, commits a checkpoint generation per epoch (stage in-graph
  via ``SaveShares``, commit after the session succeeds), and on a
  retryable mid-epoch failure resumes from the last committed
  generation, bit-exact under ``MOOSE_TPU_FIXED_KEYS``.
- :mod:`.export`: the revealed weights as ONNX and as a predictor.

The epoch graphs themselves live with the trainers:
:mod:`moose_tpu_torch.predictors.trainers`.
"""

from .checkpoint import CKPT_FORMAT, CheckpointStore  # noqa: F401
from .session import TrainingConfig, TrainingSession  # noqa: F401
