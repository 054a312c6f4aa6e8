"""Logical-computation interpreter: walks the IR in the per-host layout
(``dialects/logical.py``) or the party-stacked one
(``dialects/stacked.py``), eagerly or as the stacked layout's compiled
plan.

The counterpart of ``moose_tpu/execution/interpreter.py``.  The JAX
package compiles a plan per (computation, binding) with ``jax.jit``; the
port captures the same plan's walk as CUDA graphs
(``execution/graphs.py``) under the JAX package's names and rules:
``build_plan`` (the master key a tensor argument of ``core``), segmented
plans past ``MOOSE_TPU_JIT_SEGMENT`` ops, each segment a session with its
own key domain (``build_segmented_runner``), and the validated-jit
ladder (``_SelfCheckRunner``: whole graph, 200-op and 50-op segments,
per-op candidates with only the diverging ops pinned eager, whole-plan
eager), whose verdicts the plan registry keeps per computation; the
physical executor's plans run the same ladder through its hooks
(``execution/physical.py``).  On the
card every plan that is not eager validates: its first
``MOOSE_TPU_JIT_SELFCHECK`` evaluations (default 2) run the replayed
candidate against the eager walk under the same key, word for word.  On
the CPU nothing is captured and a plan's segments run uncaptured through
the same code, validated only under ``MOOSE_TPU_SELFCHECK_FORCE=1``.
``MOOSE_TPU_SELFCHECK_FAULT`` corrupts candidates' ops of the kinds it
lists, as in the JAX package.  The per-host layout, a graph with a
dynamic-shape kind (Select), ``use_jit=False`` and op tracing
(``MOOSE_TPU_TRACE_OPS``) walk eagerly; aes-ctr under a plan that is not
eager raises the JAX package's ``ConfigurationError``.

The master key comes from :func:`master_key_words`, with the JAX
package's ``MOOSE_TPU_FIXED_KEYS`` test knob, under which the per-host
layout's public nonces also come from the JAX package's pinned stream
(:func:`fixed_sync_seed`), so both packages draw the same masks for the
same knob value.

The walk resolves the host boundary itself: Input binds an argument,
Load reads the placement's own store and lifts the array onto the
device (an AES value through the dialect's ``lift_aes_input``), Save
brings its value to its host and writes it to that store as numpy once
the walk is done, Output reveals to its host.  A plan binds its Inputs
and Loads ahead of the walk, on the card into static buffers.  The
secret-shared checkpoints run on the per-host layout (the stacked
layout's ``unsupported_ops`` lists them, so the runtime routes them
per-host, as the reference's ``stacked.supports`` does): LoadShares
reads each owner's ``<key>#s0``/``#s1`` limb planes from that owner's
own store, and SaveShares writes each party's held pair back the same
way, so the value is never reconstructed.

An evaluation runs in an ``execute`` telemetry span (``jit`` and the
settled ``plan_mode`` among its attributes), each segment in a
``segment_execute`` profiling phase, and each op of an eager walk in an
``op:<kind>`` span under ``MOOSE_TPU_TRACE_OPS``.  :meth:`Interpreter
.replay` runs the walk up to the plan's outputs: on ``meta`` tensors it
is the stacked layout's shape-only draw replay.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import re
import secrets
import threading
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..computation import AES_TY_NAMES, Computation
from ..errors import ConfigurationError
from ..values import (
    HostBitTensor,
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
from ..dialects import host, ring
from .. import dtypes as dt
from .. import telemetry
from . import graphs


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
    value) as a runtime value on ``device``, at the op's dtype (the
    array's own where the op names none).  A ring-typed boundary (a
    lowered LoadShares) reads uint64 limb planes,
    :func:`~moose_tpu_torch.values.ring_to_limbs`'s form; a boolean one
    binds as a bit tensor of uint8, a uint64 one as its int64 words."""
    ret = op.signature.return_type
    if ret.name in ("HostRing64Tensor", "HostRing128Tensor"):
        return limbs_to_ring(
            arr, 64 if ret.name == "HostRing64Tensor" else 128, plc_name,
            device)
    dtype = ret.dtype
    if dtype is not None and dtype.is_fixedpoint:
        raise ValueError(
            f"op {op.name}: fixed-point host inputs must be loaded as floats "
            "and cast"
        )
    if dtype is not None and dtype.is_boolean:
        arr = np.asarray(arr).astype(np.uint8)
        return HostBitTensor(torch.as_tensor(arr, device=device), plc_name)
    arr = np.asarray(arr)
    if dtype is not None:
        arr = arr.astype(np.dtype(dtype.numpy_name), copy=False)
    else:
        dtype = dt.from_numpy(arr.dtype)
    if dtype.name == "uint64":
        arr = arr.view(np.int64)
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


_WARNED_KNOBS: set = set()


def _autotune_table(comp: Computation, dialect, device) -> dict:
    """``last_plan["autotune"]``'s decisions for ``comp``: the plan
    autotuner's set (``compilation.autotune.autotune_plan``), sized as
    the reference's interpreter sizes it (the stacked layout's expanded
    op estimate, ``stacked.effective_ops``, else the op count).  On the
    card a ``False`` kernel decision routes nothing (kernel or raise): it
    is reported with ``"applied": false``, and an override knob behind it
    is warned about once."""
    from ..compilation import autotune
    from ..dialects import stacked

    n_ops = (stacked.effective_ops(comp)
             if isinstance(dialect, stacked.StackedDialect)
             else len(comp.operations))
    decisions = autotune.autotune_plan(
        comp, est_ops=n_ops, device=device).as_dict()
    if torch.device(device).type == "cuda":
        for knob in ("pallas", "pallas_dot"):
            d = decisions[knob]
            if d["choice"] is False:
                d["applied"] = False
                if d["source"] == "override" and knob not in _WARNED_KNOBS:
                    _WARNED_KNOBS.add(knob)
                    from ..logger import get_logger

                    get_logger().warning(
                        "%s asks for no kernel; the port has no plain "
                        "path on the card, so every kernel runs", d["why"])
    return {"decisions": decisions}




# ---------------------------------------------------------------------------
# The walk
# ---------------------------------------------------------------------------


def _run_ops(sess, comp: Computation, names, env: dict, outputs: dict,
             saves: dict, bind, dialect, trace_ops: bool = False,
             fault_kinds=frozenset(), device=None) -> None:
    """Execute ``names`` in order against ``env``: the one op walk shared
    by the eager evaluation, the whole-graph plan, its segments and its
    per-op chunks (``moose_tpu/execution/interpreter.py``'s
    ``_run_ops``).  Names already in ``env`` (static values, a segment's
    inputs) are skipped; ``bind(sess, op, plc, env)`` resolves Input,
    Load and LoadShares.  ``fault_kinds`` (self-check candidates only)
    corrupts the results of ops of those kinds (:func:`_fault_kinds`)."""

    for name in names:
        if name in env:
            continue
        op = comp.operations[name]
        plc = comp.placement_of(op)
        # named in a failed capture's error
        graphs.current_op(name)
        if op.kind in ("Input", "Load", "LoadShares"):
            env[name] = bind(sess, op, plc, env)
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
            with op_span(op.kind, device):
                env[name] = dialect.execute_op(sess, comp, op, args)
        else:
            env[name] = dialect.execute_op(sess, comp, op, args)
        if fault_kinds and op.kind in fault_kinds:
            env[name] = _fault_perturb(env[name])


def _walk_binder(dialect, comp: Computation, arguments: dict, storage,
                 device, loads_from_arguments: bool = False):
    """Input, Load and LoadShares of the eager walk: an argument lifted
    onto ``device``, a Load read from its placement's store (or from
    ``arguments`` by op name), an AES value lifted by the dialect in the
    walk's draw order."""

    def bind(sess, op, plc, env):
        if op.kind == "LoadShares":
            return _lift_shares(
                _load_shares(storage, op, plc, env[op.inputs[0]]),
                op, plc, device)
        if op.kind == "Load" and not loads_from_arguments:
            arr = _load(storage, op, plc.name, *(env[i] for i in op.inputs))
        elif op.name in arguments:
            arr = arguments[op.name]
        else:
            raise ValueError(f"missing argument {op.name!r}")
        if op.signature.return_type.name in AES_TY_NAMES:
            # a replicated key is shared here, at its Input, as the
            # reference's walk shares it
            return dialect.lift_aes_input(sess, comp, op, arr, plc.name,
                                          device)
        return _lift_array(arr, op, plc.name, device)

    return bind


def _plan_binder(dialect, comp: Computation, dyn: dict, device):
    """Input and Load of a plan: the value bound ahead of the walk
    (:meth:`Interpreter._bind_dynamic`); an AES input's bits are lifted
    by the dialect in the walk, which shares a replicated key there."""

    def bind(sess, op, plc, env):
        value = dyn[op.name]
        if op.signature.return_type.name in AES_TY_NAMES:
            return dialect.lift_aes_input(sess, comp, op, value, plc.name,
                                          device)
        return value

    return bind


# ---------------------------------------------------------------------------
# Plans: the JAX package's compiled plan, as CUDA graphs
# ---------------------------------------------------------------------------

_DYNAMIC_SHAPE_KINDS = frozenset({"Select"})
# kinds resolved at the host boundary rather than by the dialect
_BOUNDARY_KINDS = frozenset({"Input", "Load", "Save", "Output"})


@dataclasses.dataclass
class _Plan:
    """Static execution plan for one (computation, binding) pair, the JAX
    package's ``_Plan``.  ``core(master_key, dyn)`` runs the walk under
    the master key (a 4-word int64 tensor on the device) on the values
    bound to the plan's Inputs and Loads, and returns ``(outputs,
    saves)``; ``fn``, when set, is the plan's executable (a segmented
    runner).  Deliberately does not hold the Computation: plans are
    cached weak-keyed on it."""

    order: list
    static_env: dict  # op name -> static value (strings)
    dynamic_names: list  # Input/Load ops bound at call time
    use_jit: bool
    core: Callable
    fn: Optional[Callable] = None


def _pool(device) -> Optional[Any]:
    """A new plan's private graph pool on the card; None on the CPU,
    where the plan's segments run uncaptured."""

    device = torch.device(device)
    return graphs.GraphPool(device) if device.type == "cuda" else None


def _jit(fn, name: str, device):
    """``jax.jit``'s counterpart: ``fn`` captured as a CUDA graph on the
    card, ``fn`` itself on the CPU."""

    return graphs.graphed(fn, name, _pool(device))


def _as_segment(fn, n_ops: int):
    """A whole-graph executable as the plan's one segment: one
    ``segment_execute`` profiling phase, device-fenced while a profile is
    captured."""
    from .. import profiling

    def run(master_key, dyn):
        with profiling.phase("segment_execute", segment=0, ops=n_ops):
            result = fn(master_key, dyn)
            profiling.fence(result)
        return result

    return run


def _fault_kinds() -> frozenset:
    """Op kinds listed in ``MOOSE_TPU_SELFCHECK_FAULT`` (comma-separated):
    the self-check runners corrupt those ops' results in their captured
    CANDIDATES only, forcing a synthetic divergence so the demotion
    ladder (the per-op rung's pinning included) can be exercised where no
    real divergence occurs.  Read when a candidate is built."""
    raw = os.environ.get("MOOSE_TPU_SELFCHECK_FAULT", "")
    return frozenset(k.strip() for k in raw.split(",") if k.strip())


def _fault_perturb(value):
    """Every tensor leaf of one op's result corrupted, as the JAX package
    corrupts it: a boolean flipped, anything else plus one."""

    def bump(t):
        return ~t if t.dtype == torch.bool else t + 1

    return graphs.map_tensors(value, bump)


def build_plan(comp: Computation, arguments: dict, use_jit: bool,
               segment_limit: Optional[int] = None,
               jit_segments: bool = True, dialect=None,
               fault_kinds=frozenset(), device="cpu") -> _Plan:
    """The plan of ``comp`` for the binding ``arguments``: the JAX
    package's ``build_plan``.  A string Input or Constant is static; any
    other Input, and every Load, is bound at call time.  A graph with a
    dynamic-shape kind never jits.  Past ``segment_limit`` ops a jitted
    plan is segmented (:func:`_build_segmented_plan`)."""
    import weakref

    from ..dialects import logical

    dialect = dialect if dialect is not None else logical
    device = torch.device(device)
    order = comp.toposort_names()
    static_env: dict = {}
    dynamic_names: list = []
    for name in order:
        op = comp.operations[name]
        plc = comp.placement_of(op)
        if op.kind == "Input":
            val = arguments.get(op.name)
            if val is None:
                raise ValueError(f"missing argument {op.name!r}")
            if isinstance(val, str):
                static_env[name] = HostString(val, plc.name)
            else:
                dynamic_names.append(name)
        elif op.kind == "Constant":
            if isinstance(op.attributes["value"], str):
                static_env[name] = HostString(op.attributes["value"],
                                              plc.name)
        elif op.kind in ("Load", "LoadShares"):
            dynamic_names.append(name)
    if any(comp.operations[n].kind in _DYNAMIC_SHAPE_KINDS for n in order):
        use_jit = False
    # per-op spans belong to eager plans, whose ops the host times
    trace_ops = telemetry.trace_ops_enabled() and not use_jit
    # the closure must not keep the computation alive: the plan is cached
    # weak-keyed on it
    comp_ref = weakref.ref(comp)
    limit = segment_limit if segment_limit is not None else _segment_limit()
    if use_jit and len(order) > limit:
        return _build_segmented_plan(
            comp_ref, order, static_env, dynamic_names, limit,
            jit_segments, dialect, fault_kinds, device)

    def core(master_key, dyn: dict):
        comp = comp_ref()
        if comp is None:  # pragma: no cover - defensive
            raise RuntimeError("computation was garbage-collected")
        sess = dialect.make_session(master_key, device)
        dialect.bind_placements(sess, comp)
        env: dict = dict(static_env)
        outputs: dict = {}
        saves: dict = {}
        _run_ops(sess, comp, order, env, outputs, saves,
                 _plan_binder(dialect, comp, dyn, device), dialect,
                 trace_ops, fault_kinds, device)
        return outputs, saves

    return _Plan(order, static_env, dynamic_names, use_jit, core)


def build_segmented_runner(order, static_env, dynamic_names,
                           effective_inputs, limit, jit_segments,
                           seg_exec, rand_slice, segmentation=None,
                           device="cpu"):
    """The segment orchestrator, the JAX package's: split the op order
    into consecutive segments, capture each as its own graph (one pool
    for them all: they replay in capture order), and run them from the
    host.  Values crossing a boundary travel as a segment's inputs and
    outputs; a segment reads an earlier one's outputs where that replay
    left them.  ``seg_exec(si, names, rand, dyn, env, outputs, saves)``
    runs one segment's ops; ``rand_slice(rand, si)`` narrows the per-call
    randomness.  ``jit_segments=False`` keeps the structure and runs each
    segment uncaptured: the exact reference the self-check compares
    against."""
    from .. import profiling

    chunks, in_names, out_names = (
        segmentation if segmentation is not None
        else plan_segments(
            order, static_env, effective_inputs,
            limit if limit is not None else _segment_limit(),
        )
    )
    dyn_set = set(dynamic_names)
    dyn_of = [[n for n in names if n in dyn_set] for names in chunks]
    pool = _pool(device) if jit_segments else None

    def make_seg(si, names):
        outs = out_names[si]

        def seg(rand, dyn, env_in):
            # every static value: a static op of an earlier segment may
            # feed any later one
            env: dict = dict(static_env)
            env.update(env_in)
            outputs: dict = {}
            saves: dict = {}
            seg_exec(si, names, rand, dyn, env, outputs, saves)
            return {n: env[n] for n in outs}, outputs, saves

        if not jit_segments:
            return seg
        return graphs.graphed(seg, f"segment {si}", pool)

    seg_fns = [make_seg(si, names) for si, names in enumerate(chunks)]

    def run(rand, dyn: dict):
        env: dict = {}
        outputs: dict = {}
        saves: dict = {}
        for si, fn in enumerate(seg_fns):
            # device-fenced while a profile is captured, so the segment
            # owns its device time
            with profiling.phase("segment_execute", segment=si,
                                 ops=len(chunks[si])):
                env_out, out_i, sv_i = fn(
                    rand_slice(rand, si),
                    {n: dyn[n] for n in dyn_of[si]},
                    {n: env[n] for n in in_names[si]},
                )
                profiling.fence(env_out, out_i, sv_i)
            env.update(env_out)
            outputs.update(out_i)
            saves.update(sv_i)
        return outputs, saves

    return run


def _build_segmented_plan(comp_ref, order, static_env, dynamic_names,
                          limit: Optional[int] = None,
                          jit_segments: bool = True, dialect=None,
                          fault_kinds=frozenset(), device="cpu") -> _Plan:
    """Segmentation of a plan: each segment runs its own session over the
    same master key with its own key domain (segment index + 1), so the
    PRF streams of two segments never collide; the JAX package's
    segments draw the same masks."""
    comp = comp_ref()

    def seg_exec(si, names, master_key, dyn, env, outputs, saves):
        comp = comp_ref()
        if comp is None:  # pragma: no cover - defensive
            raise RuntimeError("computation was garbage-collected")
        sess = dialect.make_session(master_key, device, key_domain=si + 1)
        dialect.bind_placements(sess, comp)
        _run_ops(sess, comp, names, env, outputs, saves,
                 _plan_binder(dialect, comp, dyn, device), dialect,
                 False, fault_kinds, device)

    run = build_segmented_runner(
        order, static_env, dynamic_names,
        lambda n: comp.operations[n].inputs,
        limit, jit_segments, seg_exec, lambda master_key, si: master_key,
        device=device,
    )
    return _Plan(order, static_env, dynamic_names, True, run, fn=run)


def heavy_jit_gate(use_jit: bool, device) -> bool:
    """The effective ``use_jit`` after the JAX package's gate: False for
    a plan that runs validated (:class:`_SelfCheckRunner`).  On the card
    every plan that is not eager is captured and validated against the
    eager walk on its first evaluations; on the CPU, where nothing is
    captured, a plan runs unvalidated unless ``MOOSE_TPU_SELFCHECK_FORCE
    =1`` (the JAX package's knob for backends without the miscompile
    the ladder exists for), which validates every plan."""
    if os.environ.get("MOOSE_TPU_SELFCHECK_FORCE") == "1":
        return False
    if not use_jit:
        return use_jit
    return torch.device(device).type != "cuda"


def _env_count(name: str, default: str) -> int:
    raw = os.environ.get(name, default)
    try:
        n = int(raw)
    except ValueError as e:
        raise ConfigurationError(
            f"{name} must be an integer, got {raw!r}"
        ) from e
    return max(0, n)


def _selfcheck_runs() -> int:
    """How many clean candidate-against-eager comparisons promote a
    validated plan (``MOOSE_TPU_JIT_SELFCHECK``, default 2; 0 disables
    the self-check, and a gated plan then runs eager)."""
    return _env_count("MOOSE_TPU_JIT_SELFCHECK", "2")


def _per_op_limit() -> int:
    """Op-count cap on the per-op rung (``MOOSE_TPU_PEROP_MAX``, default
    4000): above it the ladder skips straight to eager, and the
    runtime's cross-layout reroute applies."""
    return _env_count("MOOSE_TPU_PEROP_MAX", "4000")


def _results_equal(a, b) -> bool:
    """Word-for-word comparison of two ``(outputs, saves)`` results: the
    same structure, and every tensor leaf equal in shape, type and value
    (equal NaNs agree).  The eager walk and a replay run the same integer
    protocol from the same master key, so anything short of equality is
    a divergence."""

    la, lb = graphs.tensor_leaves(a), graphs.tensor_leaves(b)
    if len(la) != len(lb) or _skeleton(a) != _skeleton(b):
        return False
    for x, y in zip(la, lb):
        if x.shape != y.shape or x.dtype != y.dtype:
            return False
        if x.dtype.is_floating_point:
            same = (x == y) | (torch.isnan(x) & torch.isnan(y))
            if not bool(same.all()):
                return False
        elif not torch.equal(x, y):
            return False
    return True


def _skeleton(value):
    """The structure of a runtime value with its tensors left out: types,
    keys and every field that is not a tensor."""
    if isinstance(value, torch.Tensor):
        return "tensor"
    if isinstance(value, dict):
        return tuple((k, _skeleton(v)) for k, v in value.items())
    if isinstance(value, (list, tuple)):
        return (type(value).__name__,) + tuple(_skeleton(v) for v in value)
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return (type(value).__name__,) + tuple(
            (f.name, _skeleton(getattr(value, f.name)))
            for f in dataclasses.fields(value))
    return value


_PER_OP = "per-op"  # ladder sentinel: the per-op rung (not a segment size)


class _PerOpPlan:
    """The per-op rung of the ladder, the JAX package's: each op (a chunk
    of ``seg_size`` ops above ``MOOSE_TPU_PEROP_MAX``) is validated on
    its own, its eager run against its captured candidate on the same
    inputs, and only the ones that diverge are pinned to eager dispatch.
    Boundary and static ops are never pinned.  Once promoted, the ops
    between pinned ones run as captured segments (one graph for each
    stretch) and the pinned ones eagerly; on the CPU every stretch runs
    uncaptured."""

    def __init__(self, order, static_env, dynamic_names, effective_inputs,
                 seg_exec, fault_kinds, rand_slice, always_eager=(),
                 pinned=(), seg_size: int = 1, device="cpu"):
        self.seg_size = max(1, seg_size)
        self.device = torch.device(device)
        chunks, in_names, out_names = plan_segments(
            order, static_env, effective_inputs, self.seg_size)
        self._chunks = chunks
        self._in_names = in_names
        self._out_names = out_names
        dyn_set = set(dynamic_names)
        self._dyn_of = [[n for n in names if n in dyn_set]
                        for names in chunks]
        self._static_env = static_env
        self._seg_exec = seg_exec
        self._fault_kinds = frozenset(fault_kinds)
        self._rand_slice = rand_slice
        self._always = set(always_eager) | set(static_env)
        # a chunk is validatable when any of its ops computes
        self._validatable = frozenset(
            names[0] for names in chunks
            if any(n not in self._always for n in names)
        )
        # pins of an earlier runner (the plan registry): promotion
        # survives across runtimes without diverging first
        self.pinned: set = set(pinned) & self._validatable
        # candidates that failed to run once, retried before pinning
        self._failed_once: set = set()
        self._eager_fns = [self._make_run([si], fault=False)
                           for si in range(len(chunks))]
        # the per-op candidates' graphs and their pool; after promotion
        # the steady state's runs
        self._jit_fns: dict = {}
        self._pool = None
        self._mixed = None

    def _make_run(self, members, fault):
        """The function of consecutive chunks ``members``: each runs in
        its own session (the executor's ``seg_exec``); it returns what
        later chunks read, and the outputs and saves."""
        static_env = self._static_env
        seg_exec = self._seg_exec
        fk = self._fault_kinds if fault else frozenset()
        own = {n for si in members for n in self._chunks[si]}
        outs = sorted({n for si in members for n in self._out_names[si]})

        def run(rand, dyn, env_in):
            env: dict = dict(static_env)
            env.update(env_in)
            outputs: dict = {}
            saves: dict = {}
            for si in members:
                seg_exec(si, self._chunks[si], self._rand_slice(rand, si),
                         dyn, env, outputs, saves, fk)
            return {n: env[n] for n in outs}, outputs, saves

        run.ins = sorted({n for si in members for n in self._in_names[si]}
                         - own)
        run.dyn = [n for si in members for n in self._dyn_of[si]]
        return run

    def _jit_fn(self, si):

        fn = self._jit_fns.get(si)
        if fn is None:
            if self._pool is None:
                self._pool = _pool(self.device)
            seg = self._make_run([si], fault=True)
            fn = self._jit_fns[si] = graphs.graphed(
                seg, f"op {self._chunks[si][0]}", self._pool)
            fn.ins, fn.dyn = seg.ins, seg.dyn
        return fn

    @staticmethod
    def _call(fn, rand, dyn, env):
        return fn(rand, {n: dyn[n] for n in fn.dyn},
                  {n: env[n] for n in fn.ins})

    @staticmethod
    def _merge(env, outputs, saves, result):
        env_out, out_i, sv_i = result
        env.update(env_out)
        outputs.update(out_i)
        saves.update(sv_i)

    def all_pinned(self) -> bool:
        return self._validatable <= self.pinned

    def run_validate(self, rand, dyn):
        """One validation pass: every op runs eagerly (the result comes
        from these runs) and, where unpinned, also as its own captured
        candidate on the same inputs; a divergence pins the op, a
        candidate that fails to run is retried on the next pass before
        it is pinned.  Returns ((outputs, saves), new pins, retried)."""
        from ..logger import get_logger

        env: dict = {}
        outputs: dict = {}
        saves: dict = {}
        new_pins: list = []
        retried: list = []
        for si, names in enumerate(self._chunks):
            ref = self._call(self._eager_fns[si], rand, dyn, env)
            name = names[0]
            if name in self._validatable and name not in self.pinned:
                pin = False
                try:
                    got = self._call(self._jit_fn(si), rand, dyn, env)
                    pin = not _results_equal(ref, got)
                except graphs.GraphCaptureError:
                    raise  # a graph that cannot be captured is a fault
                except Exception as e:  # noqa: BLE001 - a run failure
                    # is not the divergence the rung exists for
                    if name not in self._failed_once:
                        self._failed_once.add(name)
                        retried.append(name)
                        get_logger().warning(
                            "per-op candidate for %s failed to run (%s); "
                            "will retry once", name, e)
                    else:
                        get_logger().warning(
                            "per-op candidate for %s failed twice (%s); "
                            "pinning eager", name, e)
                        pin = True
                if pin:
                    self.pinned.add(name)
                    new_pins.append(name)
                    self._jit_fns.pop(si, None)
            self._merge(env, outputs, saves, ref)
        return (outputs, saves), new_pins, retried

    def on_promoted(self) -> None:
        """The steady state: one run for each stretch of unpinned
        chunks, captured on the card, and each pinned chunk eagerly; the
        per-op candidates are dropped."""

        self._jit_fns = {}
        self._pool = None
        pool = _pool(self.device)
        runs, stretch = [], []
        for si, names in enumerate(self._chunks):
            if names[0] in self.pinned:
                if stretch:
                    runs.append((stretch, False))
                    stretch = []
                runs.append(([si], True))
            else:
                stretch.append(si)
        if stretch:
            runs.append((stretch, False))
        self._mixed = []
        for members, eager in runs:
            run = self._make_run(members, fault=False)
            if not eager:
                fn = graphs.graphed(
                    run, f"ops {self._chunks[members[0]][0]} .. "
                    f"{self._chunks[members[-1]][-1]}", pool)
                fn.ins, fn.dyn = run.ins, run.dyn
                run = fn
            self._mixed.append(run)

    def run_mixed(self, rand, dyn):
        """Steady-state execution: pinned chunks eager, the stretches
        between them captured."""
        if self._mixed is None:
            self.on_promoted()
        env: dict = {}
        outputs: dict = {}
        saves: dict = {}
        for fn in self._mixed:
            self._merge(env, outputs, saves,
                        self._call(fn, rand, dyn, env))
        return outputs, saves


class _SelfCheckBase:
    """The validated-jit ladder, the JAX package's: a captured candidate
    runs against the exact eager walk on the plan's first K evaluations
    (each under its own fresh key, the two under the same one), and the
    two must agree word for word.  K clean runs promote the plan; a
    divergence demotes the candidate down the ladder: whole-graph or
    default segments -> 200-op -> 50-op segments -> per-op candidates
    (:class:`_PerOpPlan`, only the diverging ops pinned) -> whole-plan
    eager, which ``exhausted`` reports so the runtime can reroute the
    computation to the per-host layout.  The ladder logs one summary line
    when it settles."""

    LADDER = (None, 200, 50, _PER_OP)  # segment overrides; None = default

    def __init__(self, checks: int, level: int = 0,
                 mode: Optional[str] = None):
        self._checks_init = checks
        self._checks_left = checks
        self._level = level
        self._ref_fn = None
        self._jit_fn = None
        self._per_op = None
        self._run_failed_once = False
        self._descent = [self._rung_label(level)]
        self.mode = "validating"
        if mode == "eager":
            # restored from the plan registry: the ladder ran out before
            self.mode = "eager"
            return
        # a restored promotion never validates again: no reference
        self._skip_ref_build = mode == "jit"
        self._build_candidate()
        self._skip_ref_build = False
        if self.LADDER[self._level] is _PER_OP and self._per_op is None:
            self.mode = "eager"  # the per-op rung is off (op cap)
            return
        if mode in ("jit", _PER_OP):
            self.mode = mode
            self._on_promoted()

    # -- subclass hooks ----------------------------------------------------

    def _build_candidate(self):  # pragma: no cover - abstract
        raise NotImplementedError

    def _eager_fn(self, *args):  # pragma: no cover - abstract
        raise NotImplementedError

    def _invoke(self, fn, *args):
        return fn(*args)

    def _on_promoted(self):
        """Promotion is terminal: drop what only validation needed."""
        self._ref_fn = None
        if self._per_op is not None:
            self._per_op.on_promoted()

    def _save_state(self):
        """Persist the ladder level, pins and mode (subclass hook)."""

    def _rung_label(self, level: int) -> str:
        if level >= len(self.LADDER):
            return "eager"
        rung = self.LADDER[level]
        if rung is _PER_OP:
            return "per-op"
        return "default-segments" if rung is None else f"{rung}-op"

    def _announce_resolution(self, verdict: str, warn: bool = False):
        from ..logger import get_logger

        log = get_logger().warning if warn else get_logger().info
        log("jit self-check: ladder settled (%s) -> %s",
            " -> ".join(self._descent), verdict)

    # -- state machine -----------------------------------------------------

    @property
    def exhausted(self) -> bool:
        """Every rung failed: the plan would run whole-plan eager."""
        return self.mode == "eager"

    def run(self, *args):
        if self.mode == "jit":
            return self._invoke(self._jit_fn, *args)
        if self.mode == _PER_OP:
            return self._per_op.run_mixed(*args)
        if self.mode == "eager":
            return self._eager_fn(*args)

        from .. import profiling
        from ..logger import get_logger

        if self._per_op is not None:
            return self._run_per_op_validation(*args)
        run_error = None
        with profiling.phase("ladder_validate",
                             rung=self._rung_label(self._level)):
            ref = self._invoke(self._ref_fn, *args)
            try:
                got = self._invoke(self._jit_fn, *args)
                ok = _results_equal(ref, got)
            except graphs.GraphCaptureError:
                raise  # a graph that cannot be captured is a fault
            except Exception as e:  # noqa: BLE001 - classified below
                run_error = e
        if run_error is not None:
            # a run failure is not the divergence the ladder exists for:
            # this rung is retried once before it is burnt
            if not self._run_failed_once:
                self._run_failed_once = True
                get_logger().warning(
                    "jit self-check candidate failed to run (%s); will "
                    "retry this segment size once", run_error)
                return ref
            get_logger().warning(
                "jit self-check candidate failed twice (%s); demoting",
                run_error)
            ok = False
        if ok:
            self._run_failed_once = False
            self._checks_left -= 1
            if self._checks_left <= 0:
                self.mode = "jit"
                self._announce_resolution(
                    f"promoted to jit (segment override "
                    f"{self.LADDER[self._level]}) after "
                    f"{self._checks_init} clean runs")
                self._on_promoted()
                self._save_state()
            return got
        self._descend()
        return ref

    def _descend(self):
        """Move to the next usable rung, or pin the plan eager."""
        from ..logger import get_logger

        self._level += 1
        per_op_skipped = False
        while self._level < len(self.LADDER):
            rung = self.LADDER[self._level]
            self._build_candidate()
            if rung is _PER_OP and self._per_op is None:
                per_op_skipped = True
                self._level += 1
                continue
            self._descent.append(self._rung_label(self._level))
            get_logger().debug(
                "jit self-check: candidate diverged from eager; retrying "
                "with %s",
                "per-op candidates (diverging ops will be pinned eager)"
                if rung is _PER_OP else f"{rung}-op segments")
            self._checks_left = self._checks_init
            self._run_failed_once = False
            self._save_state()
            return
        self._descent.append("eager")
        self._announce_resolution(
            "every rung diverged%s; plan pinned to whole-plan eager "
            "execution" % (
                " (per-op rung skipped: disabled or above "
                "MOOSE_TPU_PEROP_MAX)" if per_op_skipped else ""),
            warn=True)
        self.mode = "eager"
        self._jit_fn = None
        self._ref_fn = None
        self._per_op = None
        self._save_state()

    def _run_per_op_validation(self, *args):
        from .. import profiling
        from ..logger import get_logger

        try:
            with profiling.phase("ladder_validate", rung="per-op"):
                result, new_pins, retried = self._per_op.run_validate(
                    *args)
        except graphs.GraphCaptureError:
            raise
        except Exception as e:  # noqa: BLE001 - the candidate is optional
            self._descent.append("eager")
            self._announce_resolution(
                f"per-op validation failed to run ({e}); plan pinned to "
                "whole-plan eager execution", warn=True)
            self.mode = "eager"
            self._per_op = None
            self._save_state()
            return self._eager_fn(*args)
        if new_pins:
            get_logger().debug(
                "per-op jit self-check: pinned %d diverging op(s) eager: "
                "%s", len(new_pins), ", ".join(sorted(new_pins)))
            self._checks_left = self._checks_init
        elif not retried:
            self._checks_left -= 1
        if self._per_op.all_pinned():
            self._descent.append("eager")
            self._announce_resolution(
                "every %s diverged; plan pinned to whole-plan eager "
                "execution" % (
                    "op" if self._per_op.seg_size == 1
                    else f"{self._per_op.seg_size}-op chunk"),
                warn=True)
            self.mode = "eager"
            self._per_op = None
        elif self._checks_left <= 0:
            self.mode = _PER_OP
            self._announce_resolution(
                f"promoted to per-op jit with {len(self._per_op.pinned)} "
                f"op(s) pinned eager after {self._checks_init} clean runs")
            self._on_promoted()
        self._save_state()
        return result


# The plan registry, weak-keyed on the computation: the ladder level a
# plan settled at, its pinned ops and its mode, per plan key (the
# dialect's class name), so a promotion or an exhaustion survives across
# evaluations, bindings and runtimes.
_plan_registry = None


def _registry():
    global _plan_registry
    if _plan_registry is None:
        import weakref

        _plan_registry = weakref.WeakKeyDictionary()
    return _plan_registry


class _SelfCheckRunner(_SelfCheckBase):
    """The validated runner of one (computation, binding), the JAX
    package's ``_SelfCheckRunner``, shared by the stacked layout's plans
    and the physical executor's.  ``builder(comp, arguments, use_jit,
    segment_limit, jit_segments, fault_kinds=..., device=...) ->
    (plan, executable)`` builds a rung's plan (by default the stacked
    layout's: the eager reference its plan run uncaptured, the candidate
    the same plan captured with the fault knob's corruption);
    ``per_op_builder(comp, arguments, eager_plan, fault_kinds,
    nonce_seed, pinned=..., device=...)`` the per-op rung's
    :class:`_PerOpPlan`, or None where the rung is off.  With
    ``pin_nonces`` (the stacked layout's plans) the reference and the
    candidate run under one shared nonce stream; the physical executor's
    plans take every PRF key as an input and bake their sync keys as
    graph attributes, so they pin nothing."""

    def __init__(self, comp, arguments, checks: int, dialect=None,
                 builder=None, pin_nonces: bool = True,
                 per_op_builder=None, plan_key: Optional[str] = None,
                 segment_limit: Optional[int] = None, device="cpu"):
        import weakref

        # the autotuned segment limit replaces only the first rung
        self._tuned_limit = segment_limit
        self._comp_ref = weakref.ref(comp)
        self._arguments = arguments
        self._device = torch.device(device)
        self._builder = (builder if builder is not None
                         else _stacked_plan_builder(dialect))
        self._per_op_builder = (
            per_op_builder
            if per_op_builder is not None or builder is not None
            else _stacked_per_op_builder(dialect))
        self._pin_nonces = pin_nonces
        self._plan_key = plan_key or type(dialect).__name__
        # the whole-graph eager plan: the binding and the last resort
        self.eager_plan, self._eager_exec = self._builder(
            comp, arguments, False, None, True, device=self._device)
        self._order = (self.eager_plan.order
                       if hasattr(self.eager_plan, "order")
                       else self.eager_plan[0])
        self._nonce_seed = secrets.randbits(63)
        saved = _registry().get(comp, {}).get(self._plan_key)
        self._restored_pins = (
            frozenset(saved["pinned"]) if saved else frozenset())
        super().__init__(
            checks,
            level=saved["level"] if saved else 0,
            mode=saved["mode"] if saved else None,
        )

    def _build_candidate(self):
        comp = self._comp_ref()
        if comp is None:  # pragma: no cover - defensive
            raise RuntimeError("computation was garbage-collected")
        limit = self.LADDER[self._level]
        if limit is None:
            limit = self._tuned_limit  # the autotuned first rung, or None
        if limit is _PER_OP:
            self._jit_fn = None
            self._ref_fn = None
            self._per_op = None
            if self._per_op_builder is not None:
                self._per_op = self._per_op_builder(
                    comp, self._arguments, self.eager_plan, _fault_kinds(),
                    self._nonce_seed, pinned=self._restored_pins,
                    device=self._device)
            return
        self._per_op = None
        _, self._jit_fn = self._builder(
            comp, self._arguments, True, limit, True,
            fault_kinds=_fault_kinds(), device=self._device)
        if getattr(self, "_skip_ref_build", False):
            self._ref_fn = None  # a restored promotion never validates
        else:
            _, self._ref_fn = self._builder(
                comp, self._arguments, True, limit, False,
                device=self._device)

    def _eager_fn(self, *args):
        return self._invoke(self._eager_exec, *args)

    def _on_promoted(self):
        super()._on_promoted()
        # the binding was only needed to rebuild candidates
        self._arguments = None

    def _invoke(self, fn, *args):
        if not self._pin_nonces:
            return fn(*args)
        with host.deterministic_sync_keys(self._nonce_seed):
            return fn(*args)

    def _save_state(self):
        comp = self._comp_ref()
        if comp is None:  # pragma: no cover - defensive
            return
        _registry().setdefault(comp, {})[self._plan_key] = {
            "level": self._level,
            "mode": self.mode,
            "pinned": (frozenset(self._per_op.pinned)
                       if self._per_op is not None
                       else self._restored_pins),
        }

    # -- plan introspection (runtime.last_plan) ----------------------------

    @property
    def pinned_ops(self) -> list:
        """The ops the per-op rung pinned eager, sorted."""
        if self._per_op is not None:
            return sorted(self._per_op.pinned)
        return sorted(self._restored_pins) if self.mode == _PER_OP else []

    @property
    def plan_mode(self) -> str:
        """``whole-graph``, ``segmented``, ``per-op`` or ``eager``: the
        settled (or validating) plan shape."""
        if self.mode in ("eager", _PER_OP):
            return self.mode
        limit = self.LADDER[self._level]
        if limit is _PER_OP:
            return _PER_OP
        if limit is None:
            limit = self._tuned_limit
        seg = limit if limit is not None else _segment_limit()
        return "segmented" if len(self._order) > seg else "whole-graph"


def _stacked_plan_builder(dialect):
    """The ``builder`` hook of :class:`_SelfCheckRunner` over the stacked
    layout's plans: a segmented plan assembled already, else the
    whole-graph core, captured when both ``use_jit`` and
    ``jit_segments``."""

    def build(comp, arguments, use_jit, segment_limit, jit_segments,
              fault_kinds=frozenset(), device="cpu"):
        plan = build_plan(comp, arguments, use_jit,
                          segment_limit=segment_limit,
                          jit_segments=jit_segments, dialect=dialect,
                          fault_kinds=fault_kinds, device=device)
        if plan.fn is not None:  # segmented: assembled already
            return plan, plan.fn
        core = (_jit(plan.core, "whole graph", device)
                if use_jit and jit_segments else plan.core)
        return plan, _as_segment(core, len(plan.order))

    return build


def _stacked_per_op_builder(dialect):
    """The ``per_op_builder`` hook over the stacked layout's plans: one
    session for each op (key domain op index + 1, as segmented plans),
    its nonces pinned per op; None above ``MOOSE_TPU_PEROP_MAX`` ops,
    where the rung is skipped."""

    def build(comp, arguments, eager_plan, fault_kinds, nonce_seed,
              pinned=(), device="cpu"):
        import weakref

        order = eager_plan.order
        if len(order) > _per_op_limit():
            return None
        comp_ref = weakref.ref(comp)

        def seg_exec(si, names, master_key, dyn, env, outputs, saves,
                     fault=frozenset()):
            comp = comp_ref()
            if comp is None:  # pragma: no cover - defensive
                raise RuntimeError("computation was garbage-collected")
            sess = dialect.make_session(master_key, device,
                                        key_domain=si + 1)
            dialect.bind_placements(sess, comp)
            with host.deterministic_sync_keys(nonce_seed + si + 1):
                _run_ops(sess, comp, names, env, outputs, saves,
                         _plan_binder(dialect, comp, dyn, device), dialect,
                         False, fault, device)

        always = {n for n in order
                  if comp.operations[n].kind in _BOUNDARY_KINDS}
        return _PerOpPlan(
            order, eager_plan.static_env, eager_plan.dynamic_names,
            lambda n: comp.operations[n].inputs, seg_exec, fault_kinds,
            lambda mk, si: mk, always_eager=always, pinned=pinned,
            device=device)

    return build


@dataclasses.dataclass
class _Cached:
    """One cached plan: its executable, the autotuner's decisions, its
    static inputs on the card and the lock its evaluations hold from
    binding the inputs to copying the outputs out."""

    plan: _Plan
    fn: Callable
    tuned: Any
    static: Any
    lock: Any


class Interpreter:
    """Interpreter of logical computations on one device, in the layout
    of ``dialect``: ``dialects.logical`` (per-host, eager) or a
    ``dialects.stacked.StackedDialect``, whose plans are cached weak-keyed
    on the computation and run as CUDA graphs on the card."""

    def __init__(self, device, dialect):
        import weakref

        self.device = torch.device(device)
        self.dialect = dialect
        self._plan_key = type(dialect).__name__
        self._cache = weakref.WeakKeyDictionary()
        self._cache_lock = threading.Lock()
        # the plan autotuner's table of the most recent evaluate(), which
        # the runtime lifts into last_plan["autotune"]
        self.last_autotune: Optional[dict] = None
        # the settled plan of the most recent evaluate(): plan_mode,
        # pinned_ops, plan_state and the graphs it replayed
        self.last_plan_info: dict = {}

    def plan_exhausted(self, comp: Computation, arguments=None,
                       use_jit: bool = True) -> bool:
        """Whether this computation's ladder already ran out, so that an
        evaluation would run whole-plan eager: the runtime asks before
        it dispatches, and reroutes to the per-host layout."""
        if not use_jit:
            return False
        saved = _registry().get(comp, {}).get(self._plan_key)
        return bool(saved) and saved.get("mode") == "eager"

    def _plan_info(self, plan, fn) -> dict:
        runner = getattr(fn, "__self__", None)
        if isinstance(runner, _SelfCheckRunner):
            return {"plan_mode": runner.plan_mode,
                    "pinned_ops": runner.pinned_ops,
                    "plan_state": runner.mode}
        if plan.fn is not None:
            mode = "segmented"
        elif plan.use_jit:
            mode = "whole-graph"
        else:
            mode = "eager"
        return {"plan_mode": mode, "pinned_ops": [], "plan_state": "static"}

    def evaluate(self, comp: Computation,
                 arguments: Optional[dict] = None,
                 storage: Optional[dict] = None,
                 use_jit: bool = False) -> dict:
        """Run ``comp`` on ``arguments``; Load and Save read and write
        ``storage``, a mapping of placement name to its store (a dict or
        an object with ``.load``).  ``use_jit`` runs the stacked layout's
        compiled plan (captured on the card); the per-host layout, a
        graph with a dynamic-shape kind and op tracing walk eagerly."""
        from ..dialects import stacked

        arguments = arguments or {}
        storage = storage if storage is not None else {}
        _refuse_unsupported(self.dialect, comp)
        if (use_jit and isinstance(self.dialect, stacked.StackedDialect)
                and not telemetry.trace_ops_enabled()
                and not any(op.kind in _DYNAMIC_SHAPE_KINDS
                            for op in comp.operations.values())):
            return self._evaluate_plan(comp, arguments, storage)
        return self._evaluate_eager(comp, arguments, storage)

    def _evaluate_eager(self, comp, arguments, storage) -> dict:
        from .. import profiling

        dialect = self.dialect
        tuned = _autotune_table(comp, dialect, self.device)
        sess = dialect.make_session(master_key_words("logical"), self.device)
        dialect.bind_placements(sess, comp)
        sync_seed = fixed_sync_seed()
        sync_ctx = (
            host.deterministic_sync_keys(sync_seed)
            if sync_seed is not None else contextlib.nullcontext()
        )
        self.last_plan_info = {"plan_mode": "eager", "pinned_ops": [],
                               "plan_state": "static", "cuda_graphs": 0}
        # the span closes once the outputs are numpy on the host, so it
        # covers the device's work
        with telemetry.span("execute", jit=False, plan_mode="eager"), \
                sync_ctx:
            with telemetry.span("bind_arguments"):
                bound = self._bind(comp, arguments)
            # the walk is the plan's one segment, device-fenced while a
            # profile is captured
            with profiling.phase("segment_execute", segment=0,
                                 ops=len(comp.operations)):
                outputs, saves = self._walk(sess, comp, arguments, storage,
                                            bound=bound)
                profiling.fence(outputs, saves)
            self._note_dot_decisions(tuned)
            return self._copy_out(sess, outputs, saves, storage)

    @staticmethod
    def _copy_out(sess, outputs: dict, saves: dict, storage) -> dict:
        from .. import profiling

        with profiling.phase("host_transfer", outputs=len(outputs),
                             saves=len(saves)):
            # stores are written only once every op has run
            for (plc_name, key), value in saves.items():
                storage.setdefault(plc_name, {})[key] = (
                    _save_user_value(sess, value))
            return {
                name: _to_user_value(sess, outputs[name])
                for name in ordered_output_names(outputs)
            }

    def _note_dot_decisions(self, tuned: dict) -> None:
        """The per-(width, class) dot decisions the stacked secure dot
        recorded on the card; on the CPU, where the reference's kernels
        are off, neither package's dispatch records any."""
        from ..compilation import autotune

        tuned["pallas_dot_classes"] = autotune.dot_decision_table()
        self.last_autotune = tuned

    def _evaluate_plan(self, comp, arguments, storage) -> dict:

        use_jit = True
        gated = heavy_jit_gate(use_jit, self.device)
        selfcheck = use_jit and not gated and _selfcheck_runs() > 0
        use_jit = gated
        if (use_jit or selfcheck) and ring.get_prf_impl() == "aes-ctr":
            raise ConfigurationError(ring.AES_CTR_UNDER_JIT)
        cache_key = binding_cache_key(arguments, (use_jit, selfcheck))
        with self._cache_lock:
            per_comp = self._cache.get(comp)
            if per_comp is None:
                per_comp = self._cache[comp] = {}
            cached = per_comp.get(cache_key)
            if cached is None:
                cached = per_comp[cache_key] = self._build(
                    comp, arguments, use_jit, selfcheck)
        plan = cached.plan
        sync_seed = fixed_sync_seed()
        sync_ctx = (
            host.deterministic_sync_keys(sync_seed)
            if sync_seed is not None else contextlib.nullcontext()
        )
        with cached.lock:
            with telemetry.span("bind_arguments"):
                dyn = self._bind_dynamic(plan, comp, arguments, storage,
                                         cached.static)
                key = graphs.host_words(master_key_words("logical"))
                if cached.static is not None:
                    key = cached.static.put("master key", key)
            # the span closes once the outputs are numpy on the host, so
            # it covers the device's work
            with telemetry.span("execute", jit=True) as sp, sync_ctx:
                replays = graphs.replays()
                outputs, saves = cached.fn(key, dyn)
                # the plan's shape after the run: a validating evaluation
                # may have promoted, demoted or pinned
                info = self._plan_info(plan, cached.fn)
                info["cuda_graphs"] = graphs.replays() - replays
                self.last_plan_info = info
                sp.attrs["plan_mode"] = info["plan_mode"]
                sp.attrs["pinned_ops"] = len(info["pinned_ops"])
                self._note_dot_decisions(dict(cached.tuned))
                return self._copy_out(None, outputs, saves, storage)

    def _build(self, comp, arguments, use_jit, selfcheck) -> _Cached:
        """The cached plan of one binding: a validated runner, or a plan
        captured (on the card) or not, segmented past the autotuned
        limit."""
        from ..compilation import autotune

        from ..dialects import stacked

        tuned = _autotune_table(comp, self.dialect, self.device)
        seg = autotune.autotune_plan(
            comp, est_ops=stacked.effective_ops(comp),
            device=self.device)["segment_limit"]
        # an override already reaches _segment_limit(); only a predicted
        # or measured choice is passed on
        tuned_limit = (seg.choice if seg.source in ("predicted", "measured")
                       else None)
        with telemetry.span("build_plan", n_ops=len(comp.operations)):
            if selfcheck:
                runner = _SelfCheckRunner(
                    comp, arguments, _selfcheck_runs(), dialect=self.dialect,
                    plan_key=self._plan_key, segment_limit=tuned_limit,
                    device=self.device)
                plan, fn = runner.eager_plan, runner.run
            else:
                plan = build_plan(comp, arguments, use_jit,
                                  segment_limit=tuned_limit,
                                  dialect=self.dialect, device=self.device)
                if plan.fn is not None:  # segmented: assembled already
                    fn = plan.fn
                else:
                    core = (_jit(plan.core, "whole graph", self.device)
                            if plan.use_jit else plan.core)
                    fn = _as_segment(core, len(plan.order))
        static = (graphs.StaticInputs(self.device)
                  if self.device.type == "cuda" else None)
        return _Cached(plan, fn, tuned, static, threading.RLock())

    def _bind_dynamic(self, plan, comp, arguments, storage, static) -> dict:
        """The plan's Inputs and Loads bound for one evaluation: each
        lifted on the host (an AES input as its uint8 bits) and, on the
        card, copied into the plan's static buffers."""
        dyn = {}
        on_host = "cpu" if static is not None else self.device
        for name in plan.dynamic_names:
            op = comp.operations[name]
            plc = comp.placement_of(op)
            if op.kind == "LoadShares":
                value = _lift_shares(
                    _load_shares(storage, op, plc,
                                 self._static_key(plan, op, 0)),
                    op, plc, on_host)
            else:
                if op.kind == "Input":
                    arr = arguments[name]
                else:
                    query = (self._static_key(plan, op, 1)
                             if len(op.inputs) > 1 else HostString("", ""))
                    arr = _load(storage, op, plc.name,
                                self._static_key(plan, op, 0), query)
                if op.signature.return_type.name in AES_TY_NAMES:
                    value = torch.as_tensor(
                        np.asarray(arr).astype(np.uint8), device=on_host)
                else:
                    value = _lift_array(arr, op, plc.name, on_host)
            dyn[name] = (static.put(name, value) if static is not None
                         else value)
        return dyn

    @staticmethod
    def _static_key(plan, op, i: int) -> HostString:
        value = plan.static_env.get(op.inputs[i])
        if isinstance(value, HostString):
            return value
        raise ValueError(
            f"{op.kind} {op.name}: key must be statically resolvable (a "
            "string constant or string argument)"
        )

    def _bind(self, comp: Computation, arguments: dict) -> dict:
        """The float Inputs of ``comp`` lifted onto the device ahead of
        the walk (an AES input is shared at its Input, in the walk's
        draw order, so it stays there)."""
        bound = {}
        for name in comp.toposort_names():
            op = comp.operations[name]
            if (op.kind == "Input" and name in arguments
                    and op.signature.return_type.name not in AES_TY_NAMES
                    and not isinstance(arguments[name], str)):
                bound[name] = _lift_array(
                    arguments[name], op, comp.placement_of(op).name,
                    self.device)
        return bound

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
              storage, loads_from_arguments: bool = False,
              bound: Optional[dict] = None) -> tuple:
        env: dict = dict(bound or {})
        outputs: dict = {}
        saves: dict = {}
        _run_ops(sess, comp, comp.toposort_names(), env, outputs, saves,
                 _walk_binder(self.dialect, comp, arguments, storage,
                              self.device, loads_from_arguments),
                 self.dialect, telemetry.trace_ops_enabled(),
                 device=self.device)
        return outputs, saves

