"""Logical-computation interpreter: walks the IR and executes each op
eagerly in the stacked layout.

The eager walk of ``moose_tpu/execution/interpreter.py``.  PyTorch runs
eagerly, so the JAX package's validated-jit ladder (whole-graph,
segmented and per-op plans with self-checks) has no counterpart here.
The master key comes from :func:`master_key_words`, with the JAX
package's ``MOOSE_TPU_FIXED_KEYS`` test knob, so both packages draw the
same masks for the same knob value.
"""

from __future__ import annotations

import os
import re
import secrets
from typing import Any, Optional

import numpy as np
import torch

from ..computation import Computation
from ..errors import ConfigurationError
from ..values import HostFixedTensor, HostTensor, to_numpy
from ..dialects import stacked
from .. import dtypes as dt


def master_key_words(domain: str = "") -> np.ndarray:
    """The per-evaluation 128-bit master key as four uint32 words.

    Normally drawn from local entropy.  Under ``MOOSE_TPU_FIXED_KEYS``
    (TEST-ONLY: bit-exactness tests need reproducible keys) the key
    derives deterministically from the knob value and ``domain``; that
    requires ``MOOSE_TPU_ALLOW_WEAK_PRF=1``, since fixed keys void all
    secrecy between the parties."""
    fixed = os.environ.get("MOOSE_TPU_FIXED_KEYS")
    if fixed:
        if os.environ.get("MOOSE_TPU_ALLOW_WEAK_PRF") != "1":
            raise ConfigurationError(
                "MOOSE_TPU_FIXED_KEYS is a testing knob and requires "
                "MOOSE_TPU_ALLOW_WEAK_PRF=1 — fixed PRF keys void all "
                "inter-party secrecy"
            )
        import hashlib

        digest = hashlib.blake2b(
            f"{fixed}|{domain}".encode(), digest_size=16
        ).digest()
        return np.frombuffer(digest, dtype=np.uint32)
    return np.frombuffer(secrets.token_bytes(16), dtype=np.uint32)


def _lift_array(arr, op, plc_name: str, device) -> HostTensor:
    """Bind a host-boundary array as a runtime value on ``device``."""
    dtype = op.signature.return_type.dtype
    if dtype is None or dtype.is_fixedpoint or dtype.name not in (
        "float32", "float64"
    ):
        raise NotImplementedError(
            f"op {op.name}: the port binds float inputs only "
            "(ROADMAP queue 1, item 6)"
        )
    value = torch.as_tensor(
        np.asarray(arr, dtype=np.dtype(dtype.numpy_name)), device=device
    )
    return HostTensor(value, plc_name, dtype)


def _to_user_value(sess, value):
    """Decoded floats for a fixed-point value; bools for bits, uint64 (or
    Python ints at ring128) for ring words, as ``to_numpy`` gives them."""
    if isinstance(value, HostFixedTensor):
        value = sess.host.fixedpoint_decode(value.plc, value, dt.float64)
    return to_numpy(value)


def ordered_output_names(outputs) -> list:
    """Outputs in declaration order (the tracer names them output_{i})."""

    def sort_key(name):
        m = re.match(r"output_(\d+)$", name)
        return (0, int(m.group(1))) if m else (1, name)

    return sorted(outputs, key=sort_key)


class Interpreter:
    """Eager interpreter of logical computations on one device."""

    def __init__(self, device):
        self.device = torch.device(device)

    def evaluate(self, comp: Computation,
                 arguments: Optional[dict] = None) -> dict:
        arguments = arguments or {}
        missing = stacked.unsupported_ops(comp)
        if missing:
            raise NotImplementedError(
                "the port cannot run these ops yet: " + ", ".join(sorted({
                    f"{p} {k} ({stacked.roadmap_item(p, k)})"
                    for p, k in missing
                }))
            )
        sess = stacked.StackedSession(
            master_key_words("logical"), self.device
        )
        env: dict[str, Any] = {}
        outputs: dict[str, Any] = {}
        for name in comp.toposort_names():
            op = comp.operations[name]
            plc = comp.placement_of(op)
            if op.kind == "Input":
                if name not in arguments:
                    raise ValueError(f"missing argument {name!r}")
                env[name] = _lift_array(
                    arguments[name], op, plc.name, self.device
                )
                continue
            if op.kind == "Output":
                value = stacked.to_host(sess, plc.name, env[op.inputs[0]])
                env[name] = value
                outputs[op.attributes.get("tag", name)] = value
                continue
            args = [env[i] for i in op.inputs]
            env[name] = stacked.execute_op(sess, comp, op, args)
        return {
            name: _to_user_value(sess, outputs[name])
            for name in ordered_output_names(outputs)
        }
