"""Logical-computation interpreter: walks the IR and executes each op
eagerly, in the per-host layout (``dialects/logical.py``) or the
party-stacked one (``dialects/stacked.py``).

The eager walk of ``moose_tpu/execution/interpreter.py``.  PyTorch runs
eagerly, so the JAX package's validated-jit ladder (whole-graph,
segmented and per-op plans with self-checks) has no counterpart here.
The master key comes from :func:`master_key_words`, with the JAX
package's ``MOOSE_TPU_FIXED_KEYS`` test knob, under which the per-host
layout's public nonces also come from the JAX package's pinned stream
(:func:`fixed_sync_seed`), so both packages draw the same masks for the
same knob value.

The walk resolves the host boundary itself: Input binds an argument,
Load reads the placement's own store and lifts the array onto the
device (an AES value through the dialect's ``lift_aes_input``), Save
brings its value to its host and writes it to that store as numpy once
the walk is done, Output reveals to its host.  The secret-shared
checkpoints run on the per-host layout (the stacked layout's
``unsupported_ops`` lists them, so the runtime routes them per-host, as
the reference's ``stacked.supports`` does): LoadShares reads each
owner's ``<key>#s0``/``#s1`` limb planes from that owner's own store,
and SaveShares writes each party's held pair back the same way, so the
value is never reconstructed.

An evaluation runs in an ``execute`` telemetry span, and each op in an
``op:<kind>`` span under ``MOOSE_TPU_TRACE_OPS``.  :meth:`Interpreter
.replay` runs the walk up to the plan's outputs: on ``meta`` tensors it
is the stacked layout's shape-only draw replay.
"""

from __future__ import annotations

import contextlib
import os
import re
import secrets
from typing import Any, Optional

import numpy as np
import torch

from ..computation import AES_TY_NAMES, Computation
from ..errors import ConfigurationError
from ..values import (
    HostFixedTensor,
    HostRingTensor,
    HostString,
    HostTensor,
    HostUnit,
    RepFixedTensor,
    RepTensor,
    limbs_to_ring,
    ring_to_limbs,
    to_numpy,
)
from ..dialects import host
from .. import dtypes as dt
from .. import telemetry


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


def fixed_sync_seed() -> Optional[int]:
    """The Philox seed that pins the per-host layout's public sync-key
    nonces under ``MOOSE_TPU_FIXED_KEYS``: the JAX package's
    ``_fixed_sync_seed``, an 8-byte blake2b digest of the knob value.
    None when the knob is off; nonces then come from OS entropy."""
    fixed = os.environ.get("MOOSE_TPU_FIXED_KEYS")
    if not fixed:
        return None
    import hashlib

    digest = hashlib.blake2b(f"{fixed}|sync".encode(),
                             digest_size=8).digest()
    return int.from_bytes(digest, "little")


def _lift_array(arr, op, plc_name: str, device):
    """Bind a host-boundary array (an Input's argument, a Load's stored
    value) as a runtime value on ``device``, at the op's dtype.  A
    ring-typed boundary (a lowered LoadShares) reads uint64 limb planes,
    :func:`~moose_tpu_torch.values.ring_to_limbs`'s form."""
    ret = op.signature.return_type
    if ret.name in ("HostRing64Tensor", "HostRing128Tensor"):
        return limbs_to_ring(
            arr, 64 if ret.name == "HostRing64Tensor" else 128, plc_name,
            device)
    dtype = ret.dtype
    if dtype is None or dtype.is_fixedpoint or dtype.name not in (
        "float32", "float64"
    ):
        raise NotImplementedError(
            f"op {op.name}: the port binds float inputs only "
            "(ROADMAP queue 1, item 6)"
        )
    arr = np.asarray(arr, dtype=np.dtype(dtype.numpy_name))
    if not arr.flags.writeable:
        # a read-only buffer (np.frombuffer): torch would share it, and warn
        arr = arr.copy()
    return HostTensor(torch.as_tensor(arr, device=device), plc_name, dtype)


def _load(storage, op, plc_name: str, key: HostString,
          query: HostString):
    """The array stored under ``key`` on ``plc_name``: a storage object
    (anything with ``.load``, such as ``FilesystemStorage``) reads it with
    the query, a dict by key."""
    for what, v in (("key", key), ("query", query)):
        if not isinstance(v, HostString):
            raise ValueError(
                f"Load {op.name}: the {what} must be a string, found "
                f"{type(v).__name__}"
            )
    store = storage.get(plc_name, {})
    if key.value not in store:
        raise KeyError(
            f"no value for key {key.value!r} in storage of {plc_name!r}"
        )
    if query.value and hasattr(store, "load"):
        return store.load(key.value, query.value)
    return store[key.value]


def _save_user_value(sess, value):
    """Storage form of a Save'd value: numpy, never a device tensor.  Ring
    words persist as uint64 limb planes ``(1 or 2, *shape)``, lossless
    through ``.npy`` (the SaveShares/LoadShares round trip); anything
    else as the user gets it."""
    if isinstance(value, HostRingTensor):
        return ring_to_limbs(value)
    return _to_user_value(sess, value)


def _load_shares(storage, op, plc, key) -> list:
    """The six limb arrays of a LoadShares binding, party-major and
    slot-minor: each owner's ``<key>#s0`` and ``#s1`` from that owner's
    own store."""
    from ..compilation.lowering import share_key

    if not isinstance(key, HostString):
        raise ValueError(
            f"LoadShares {op.name}: the key must be a string, found "
            f"{type(key).__name__}"
        )
    arrs = []
    for owner in plc.owners:
        store = storage.get(owner, {})
        for slot in (0, 1):
            skey = share_key(key.value, slot)
            if skey not in store:
                raise KeyError(
                    f"no value for key {skey!r} in storage of {owner!r}"
                )
            arrs.append(store[skey])
    return arrs


def _lift_shares(arrs, op, plc, device) -> RepFixedTensor:
    """Reassemble a replicated sharing from the six party-held limb
    arrays of a LoadShares binding (party-major, slot-minor)."""
    dtype = op.signature.return_type.dtype
    width = 64 if dtype.name == "fixed64" else 128
    it = iter(arrs)
    shares = tuple(
        tuple(limbs_to_ring(next(it), width, owner, device)
              for _ in range(2))
        for owner in plc.owners
    )
    return RepFixedTensor(
        RepTensor(shares, plc.name),
        dtype.integral_precision,
        dtype.fractional_precision,
    )


def _stage_shares(sess, plc, key, value, saves) -> None:
    """Stage a SaveShares op: each party's two held ring tensors land in
    ``saves`` under that party's own (owner, key) slots; the plaintext is
    never reconstructed."""
    from ..compilation.lowering import _shares_of, share_key
    from ..dialects import logical

    if not isinstance(key, HostString):
        raise ValueError(
            f"SaveShares: the key must be a string, found "
            f"{type(key).__name__}"
        )
    rep_tensor, _, _ = _shares_of(logical.to_rep(sess, plc, value))
    for i, owner in enumerate(plc.owners):
        for slot in (0, 1):
            saves[(owner, share_key(key.value, slot))] = (
                rep_tensor.shares[i][slot]
            )


def _to_user_value(sess, value):
    """Decoded floats for a fixed-point value; bools for bits, uint64 (or
    Python ints at ring128) for ring words, as ``to_numpy`` gives them;
    None for a Save's unit."""
    if isinstance(value, HostUnit):
        return None
    if isinstance(value, HostFixedTensor):
        value = host.fixedpoint_decode(value, value.plc, dt.float64)
    return to_numpy(value)


def binding_cache_key(arguments, use_jit):
    """Plan-cache key of one argument binding: shapes/dtypes for arrays,
    values for static scalars/strings (the JAX package's key, shared by
    the runtime's lowered-graph cache and the physical executor)."""
    parts = [use_jit]
    for name, val in sorted(arguments.items()):
        if isinstance(val, (str, int, float)):
            parts.append((name, val))
        else:
            arr = np.asarray(val)
            parts.append((name, arr.shape, str(arr.dtype)))
    return tuple(parts)


def ordered_output_names(outputs) -> list:
    """Outputs in declaration order (the tracer names them output_{i})."""

    def sort_key(name):
        m = re.match(r"output_(\d+)$", name)
        return (0, int(m.group(1))) if m else (1, name)

    return sorted(outputs, key=sort_key)


def _segment_limit() -> int:
    """The JAX package's jit segment limit (``MOOSE_TPU_JIT_SEGMENT``,
    default 2000; 0 disables): the runtime's route threshold for a
    graph's estimated lowered size, and the fixed chunk size of
    :func:`plan_segments`."""
    raw = os.environ.get("MOOSE_TPU_JIT_SEGMENT", "2000")
    try:
        n = int(raw)
    except ValueError as e:
        raise ConfigurationError(
            f"MOOSE_TPU_JIT_SEGMENT must be an integer, got {raw!r}"
        ) from e
    return n if n > 0 else (1 << 62)


def plan_segments(order, static_env, effective_inputs, limit, chunks=None):
    """Boundary dataflow of a segmented op order, the JAX package's
    ``plan_segments``: split ``order`` into consecutive ``limit``-sized
    chunks (or take ``chunks`` as given) and compute, per chunk, which
    earlier-produced values it consumes (``in_names``) and which of its
    values later chunks need (``out_names``).  ``effective_inputs(name)``
    yields the dataflow inputs of one op.  An input whose producer sits
    in no chunk (a pending Receive, a host-boundary op resolved outside
    the chunks) crosses into its consuming chunk as an ordinary input
    and is never a chunk output.  The schedule analysis
    (``compilation.analysis.schedule``) reconstructs a worker's plan
    with it."""
    if chunks is None:
        chunks = [order[i:i + limit] for i in range(0, len(order), limit)]
    produced_by = {}
    for si, names in enumerate(chunks):
        for n in names:
            produced_by[n] = si

    in_names: list[list[str]] = []
    for si, names in enumerate(chunks):
        ins = set()
        for n in names:
            for i in effective_inputs(n):
                if i in static_env:
                    continue
                if produced_by.get(i, -1) != si:
                    ins.add(i)
        in_names.append(sorted(ins))
    out_names: list[list[str]] = [[] for _ in chunks]
    for si in range(len(chunks)):
        needed = set()
        for sj in range(si + 1, len(chunks)):
            needed.update(
                n for n in in_names[sj] if produced_by.get(n) == si
            )
        out_names[si] = sorted(needed)
    return chunks, in_names, out_names


@contextlib.contextmanager
def op_span(kind: str, device):
    """An ``op:<kind>`` telemetry span (``MOOSE_TPU_TRACE_OPS``) that
    closes once the card has finished the op: same-named spans
    aggregate in ``last_timings``, a per-kind time profile of an eager
    run."""
    with telemetry.span(f"op:{kind}"):
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)


def _refuse_unsupported(dialect, comp: Computation) -> None:
    missing = dialect.unsupported_ops(comp)
    if missing:
        raise NotImplementedError(
            "the port cannot run these ops yet: " + ", ".join(sorted({
                f"{p} {k} ({dialect.roadmap_item(p, k)})"
                for p, k in missing
            }))
        )


class Interpreter:
    """Eager interpreter of logical computations on one device, in the
    layout of ``dialect``: ``dialects.logical`` (per-host) or
    ``dialects.stacked``."""

    def __init__(self, device, dialect):
        self.device = torch.device(device)
        self.dialect = dialect

    def evaluate(self, comp: Computation,
                 arguments: Optional[dict] = None,
                 storage: Optional[dict] = None) -> dict:
        """Run ``comp`` on ``arguments``; Load and Save read and write
        ``storage``, a mapping of placement name to its store (a dict or
        an object with ``.load``)."""
        arguments = arguments or {}
        storage = storage if storage is not None else {}
        dialect = self.dialect
        _refuse_unsupported(dialect, comp)
        sess = dialect.make_session(master_key_words("logical"), self.device)
        dialect.bind_placements(sess, comp)
        sync_seed = fixed_sync_seed()
        sync_ctx = (
            host.deterministic_sync_keys(sync_seed)
            if sync_seed is not None else contextlib.nullcontext()
        )
        # the span closes once the outputs are numpy on the host, so it
        # covers the device's work
        with telemetry.span("execute", jit=False, plan_mode="eager"), \
                sync_ctx:
            outputs, saves = self._walk(sess, comp, arguments, storage)
            # stores are written only once every op has run
            for (plc_name, key), value in saves.items():
                storage.setdefault(plc_name, {})[key] = _save_user_value(
                    sess, value)
            return {
                name: _to_user_value(sess, outputs[name])
                for name in ordered_output_names(outputs)
            }

    def replay(self, comp: Computation, arguments: dict) -> dict:
        """Run the walk of :meth:`evaluate` up to the plan's outputs (each
        Output revealed to its host, nothing decoded, no store written)
        and return them by tag.  A Load reads ``arguments[op name]``, as
        the JAX package's plan binds it.  On the ``meta`` device this is
        the stacked layout's shape-only replay: every kernel wrapper
        returns meta outputs of its shape and every draw group records
        in the draw ledger and fills nothing."""
        dialect = self.dialect
        _refuse_unsupported(dialect, comp)
        sess = dialect.make_session(master_key_words("logical"), self.device)
        dialect.bind_placements(sess, comp)
        outputs, _ = self._walk(sess, comp, arguments, {},
                                loads_from_arguments=True)
        return outputs

    def _walk(self, sess, comp: Computation, arguments: dict,
              storage, loads_from_arguments: bool = False) -> tuple:
        dialect = self.dialect
        env: dict[str, Any] = {}
        outputs: dict[str, Any] = {}
        saves: dict[tuple, Any] = {}
        trace_ops = telemetry.trace_ops_enabled()
        for name in comp.toposort_names():
            op = comp.operations[name]
            plc = comp.placement_of(op)
            if op.kind in ("Input", "Load"):
                if op.kind == "Load" and not loads_from_arguments:
                    arr = _load(storage, op, plc.name,
                                *(env[i] for i in op.inputs))
                elif name in arguments:
                    arr = arguments[name]
                else:
                    raise ValueError(f"missing argument {name!r}")
                if op.signature.return_type.name in AES_TY_NAMES:
                    # a replicated key is shared here, at its Input, as
                    # the reference's walk shares it
                    env[name] = dialect.lift_aes_input(
                        sess, comp, op, arr, plc.name, self.device
                    )
                else:
                    env[name] = _lift_array(arr, op, plc.name, self.device)
                continue
            if op.kind == "LoadShares":
                env[name] = _lift_shares(
                    _load_shares(storage, op, plc, env[op.inputs[0]]),
                    op, plc, self.device)
                continue
            if op.kind == "SaveShares":
                _stage_shares(sess, plc, env[op.inputs[0]],
                              env[op.inputs[1]], saves)
                env[name] = HostUnit(plc.owners[-1])
                continue
            if op.kind == "Save":
                key = env[op.inputs[0]]
                if not isinstance(key, HostString):
                    raise ValueError(
                        f"Save {op.name}: the key must be a string, found "
                        f"{type(key).__name__}"
                    )
                saves[(plc.name, key.value)] = dialect.to_host(
                    sess, plc.name, env[op.inputs[1]]
                )
                env[name] = HostUnit(plc.name)
                continue
            if op.kind == "Output":
                value = env[op.inputs[0]]
                if not isinstance(value, HostUnit):
                    value = dialect.to_host(sess, plc.name, value)
                env[name] = value
                outputs[op.attributes.get("tag", name)] = value
                continue
            args = [env[i] for i in op.inputs]
            if trace_ops:
                with op_span(op.kind, self.device):
                    env[name] = dialect.execute_op(sess, comp, op, args)
            else:
                env[name] = dialect.execute_op(sess, comp, op, args)
        return outputs, saves
