"""Physical executor: runs a *lowered* (host-level) computation.

The port of ``moose_tpu/execution/physical.py`` (the reference's
per-worker executor over compiled physical graphs,
``moose/src/execution/asynchronous.rs:456-529``), in its local mode: all
hosts in one process on one device, every host op one call of the eager
session's host kernels.  PRF keys are inputs of the plan, one per
PrfKeyGen (and unseeded Sample) op, drawn fresh for each evaluation, or
under ``MOOSE_TPU_FIXED_KEYS`` derived from the op's name, as the JAX
package derives them; sync keys are attributes of the graph.  So an
evaluation of one lowered graph under fixed keys gives the JAX package's
words.  A Receive reads its Send's value on the same device.

At ``use_jit`` a graph runs as the JAX package's compiled plan, under the
same names: ``_build_plan`` (the whole graph in one session),
``_build_segmented_physical`` past ``MOOSE_TPU_JIT_SEGMENT`` ops (each
segment given only its own keys, a Receive reading its Send's input as a
boundary value), and the validated-jit ladder of
``interpreter._SelfCheckRunner`` through its hooks
(``_physical_plan_builder``, ``_physical_per_op_builder``, plan key
``"physical"``).  On the card each plan or segment is captured as a CUDA
graph (``execution/graphs.py``) and validated against its eager run on
its first evaluations, word for word; on the CPU its segments run
uncaptured, validated only under ``MOOSE_TPU_SELFCHECK_FORCE=1``.  The
keys of an evaluation sit in one ``(n_keys, 4)`` table on the device
(:func:`plan_keys`), copied in before a replay; a DeriveSeed of such a
key is a ``values.DeviceSeed`` and each SampleSeeded one K7 launch that
makes its seed on the card from the key row and the baked sync key, so
no seed is derived on the host.  Without ``use_jit`` the plan walks
eagerly with host keys, each seed derived on the host.  Under
``aes-ctr`` a plan's jitted form refuses the host-side PRF with the JAX
package's ``ConfigurationError``, which its ladder treats as the JAX
package's does (a candidate that fails to run).

On the card a host ring Dot launches K1 in its product-only mode, a host
ring Mul K4 and every SampleSeeded one K7 draw; the lowered graph holds
no fused protocol step, so K2, K3, K5 and K6 do not run here.  One
worker's share of a lowered graph (its own ops, Send/Receive over a
networking backend) runs in ``distributed.worker.execute_role``, on this
module's kernels.
"""

from __future__ import annotations

import contextvars
import dataclasses
import os
import secrets
import threading
import weakref
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from .. import devices, telemetry
from .. import dtypes as dt
from ..computation import Computation
from ..dialects import host
from ..errors import (
    KernelError,
    MissingArgumentError,
    StorageError,
    UnimplementedError,
)
from ..values import (
    DeviceSeed,
    HostBitTensor,
    HostPrfKey,
    HostRingTensor,
    HostSeed,
    HostShape,
    HostString,
    HostTensor,
    HostUnit,
)
from . import graphs
from .interpreter import (
    Interpreter,
    _as_segment,
    _fault_perturb,
    _jit,
    _lift_array,
    _per_op_limit,
    _PerOpPlan,
    _segment_limit,
    _selfcheck_runs,
    _SelfCheckBase,
    _SelfCheckRunner,
    binding_cache_key,
    build_segmented_runner,
    heavy_jit_gate,
    master_key_words,
    op_span,
    plan_segments,
)
from .session import EagerSession


def _fresh_key_words(domain: str = "") -> tuple:
    """Fresh 128-bit key words; under MOOSE_TPU_FIXED_KEYS (test-only,
    see ``interpreter.master_key_words``) derived from ``domain``, the key
    op's name, so lowered-plan evaluations are reproducible."""
    if os.environ.get("MOOSE_TPU_FIXED_KEYS"):
        words = master_key_words(f"physical|{domain}")
    else:
        words = np.frombuffer(secrets.token_bytes(16), dtype=np.uint32)
    return tuple(int(w) for w in words)


def _ring_width_of(ty_name: str) -> int:
    return 128 if "128" in ty_name else 64


def _sample_from_seed(sess, plc, shp, seed, ret_name: str, attrs):
    """Shared Sample/SampleSeeded dispatch: bit tensor vs bit-valued ring
    (max_value == 1) vs uniform ring draw."""
    if ret_name == "HostBitTensor":
        return sess.sample_bit_tensor_seeded(plc, shp, seed)
    width = _ring_width_of(ret_name)
    if attrs.get("max_value") == 1:
        return sess.sample_bits_seeded(plc, shp, seed, width)
    return sess.sample_uniform_seeded(plc, shp, seed, width)


def execute_kernel(sess: EagerSession, op, plc: str, args: list):
    """Execute one host-level operation with concrete values."""
    kind = op.kind
    A = op.attributes
    ret = op.signature.return_type

    if kind == "Identity":
        return sess.place(plc, args[0])
    if kind == "Constant":
        value = A["value"]
        if ret.name == "HostShape":
            return HostShape(tuple(int(d) for d in value), plc)
        if ret.name == "HostString":
            return HostString(value, plc)
        if ret.name.startswith("HostRing"):
            return sess.ring_constant(plc, value, _ring_width_of(ret.name))
        if ret.name == "HostBitTensor":
            return HostBitTensor(graphs.upload(
                np.asarray(value).astype(np.uint8), sess.device), plc)
        return sess.constant(plc, np.asarray(value), ret.dtype)
    if kind == "Fill":
        return sess.fill(plc, args[0], A["value"], ret.name)
    if kind == "Zeros":
        return sess.zeros(plc, args[0], ret.dtype or dt.float64)
    if kind == "Ones":
        return sess.ones(plc, args[0], ret.dtype or dt.float64)
    if kind == "PrfKeyGen":
        # the plan feeds keys as inputs (_run_physical_ops); this is the
        # direct call's path, a distinct key for each op under fixed keys
        return HostPrfKey(_fresh_key_words(op.name), plc, origin=op.name)
    if kind == "DeriveSeed":
        return sess.derive_seed(plc, args[0], A["sync_key"])
    if kind == "SampleSeeded":
        return _sample_from_seed(sess, plc, args[0], args[1], ret.name, A)
    if kind == "Sample":
        seed = HostSeed(_fresh_key_words(op.name), plc,
                        origin=(("fresh", op.name), None))
        return _sample_from_seed(sess, plc, args[0], seed, ret.name, A)
    if kind == "Add":
        return sess.add(plc, args[0], args[1])
    if kind == "Sub":
        return sess.sub(plc, args[0], args[1])
    if kind == "Mul":
        return sess.mul(plc, args[0], args[1])
    if kind == "Div":
        return sess.div(plc, args[0], args[1])
    if kind == "Dot":
        return sess.dot(plc, args[0], args[1])
    if kind == "Conv2D":
        return sess.conv2d(
            plc, args[0], args[1],
            tuple(A.get("strides", (1, 1))), A.get("padding", "VALID"),
        )
    if kind == "Im2Col":
        return sess.im2col(
            plc, args[0], A["kh"], A["kw"],
            tuple(A.get("strides", (1, 1))), A.get("padding", "VALID"),
        )
    if kind in ("AvgPool2D", "MaxPool2D"):
        method = (
            sess.avg_pool2d if kind == "AvgPool2D" else sess.max_pool2d
        )
        strides = A.get("strides")
        return method(
            plc, args[0], tuple(A["pool_size"]),
            tuple(strides) if strides is not None else None,
            A.get("padding", "VALID"),
        )
    if kind == "And":
        return sess.and_(plc, args[0], args[1])
    if kind == "Or":
        return sess.or_(plc, args[0], args[1])
    if kind == "Xor":
        return sess.xor(plc, args[0], args[1])
    if kind == "Neg":
        if isinstance(args[0], HostBitTensor):
            return sess.bit_neg(plc, args[0])
        return sess.neg(plc, args[0])
    if kind == "Sum":
        return sess.sum(plc, args[0], A.get("axis"))
    if kind == "Mean":
        return sess.mean(plc, args[0], A.get("axis"))
    if kind == "Shl":
        return sess.shl(plc, args[0], A["amount"])
    if kind == "Shr":
        if A.get("arithmetic"):
            return sess.shr_arith(plc, args[0], A["amount"])
        return sess.shr(plc, args[0], A["amount"])
    if kind == "BitExtract":
        return sess.bit_extract(plc, args[0], A["bit_idx"])
    if kind == "RingInject":
        return sess.ring_inject(
            plc, args[0], A["bit_idx"], _ring_width_of(ret.name)
        )
    if kind == "BitDecompose":
        return sess.decompose_bits(plc, args[0])
    if kind == "BitCompose":
        return sess.compose_bits(plc, args[0], _ring_width_of(ret.name))
    if kind == "RingFixedpointEncode":
        return sess.ring_fixedpoint_encode(
            plc, args[0], A["scaling_exp"], _ring_width_of(ret.name)
        )
    if kind == "RingFixedpointDecode":
        return sess.ring_fixedpoint_decode(
            plc, args[0], A["scaling_exp"], ret.dtype or dt.float64
        )
    if kind == "RingFixedpointMean":
        return sess.ring_fixedpoint_mean(
            plc, args[0], A.get("axis"), A["scaling_exp"]
        )
    if kind == "Cast":
        x = args[0]
        target = A["dtype"]
        if isinstance(x, HostRingTensor):
            x = sess.cast_ring_lo(plc, x, dt.uint64)
            if target.name == "uint64":
                return x
        return sess.cast(plc, x, target)
    if kind == "Exp":
        return sess.exp(plc, args[0])
    if kind == "Log":
        return sess.log(plc, args[0])
    if kind == "Log2":
        return sess.log2(plc, args[0])
    if kind == "Sqrt":
        return sess.sqrt(plc, args[0])
    if kind == "Sigmoid":
        return sess.sigmoid(plc, args[0])
    if kind == "Relu":
        return sess.relu(plc, args[0])
    if kind == "Abs":
        return sess.abs(plc, args[0])
    if kind == "Sign":
        return sess.sign(plc, args[0])
    if kind == "Pow2":
        return sess.pow2(plc, args[0])
    if kind == "Softmax":
        return sess.softmax(plc, args[0], A["axis"])
    if kind == "Argmax":
        return sess.argmax(plc, args[0], A["axis"])
    if kind == "Maximum":
        return sess.maximum(plc, args)
    if kind == "Inverse":
        return sess.inverse(plc, args[0])
    if kind == "Less":
        return sess.less(plc, args[0], args[1])
    if kind == "Greater":
        return sess.greater(plc, args[0], args[1])
    if kind == "Equal":
        return sess.equal(plc, args[0], args[1])
    if kind == "Mux":
        return sess.mux(plc, args[0], args[1], args[2])
    if kind == "Select":
        return sess.select(plc, args[0], A["axis"], args[1])
    if kind == "Reshape":
        return sess.reshape(plc, args[0], args[1])
    if kind == "Broadcast":
        return sess.broadcast(plc, args[0], args[1])
    if kind == "Slice":
        spec = A.get("slices", A.get("slice_spec"))
        if spec is not None:
            slices = tuple(
                Ellipsis
                if s == "..."
                else (slice(*s) if isinstance(s, (tuple, list)) else s)
                for s in spec
            )
            return sess.strided_slice(plc, args[0], slices)
        return sess.slice(plc, args[0], A["begin"], A["end"])
    if kind == "ExpandDims":
        return sess.expand_dims(plc, args[0], A["axis"])
    if kind == "Squeeze":
        return sess.squeeze(plc, args[0], A.get("axis"))
    if kind == "Concat":
        return sess.concat(plc, args, A.get("axis", 0))
    if kind == "IndexAxis":
        return sess.index_axis(plc, args[0], A["axis"], A["index"])
    if kind == "Transpose":
        return sess.transpose(plc, args[0], A.get("axes"))
    if kind == "Diag":
        return sess.diag(plc, args[0])
    if kind == "ShlDim":
        return sess.shl_dim(plc, args[0], A["amount"], A["bit_length"])
    if kind == "AtLeast2D":
        return sess.at_least_2d(plc, args[0], A.get("to_column_vector", False))
    if kind == "Shape":
        return sess.shape(plc, args[0])
    if kind == "AddN":
        # variadic sum (reference AddNOp, computation.rs Signature::variadic)
        out = args[0]
        for a in args[1:]:
            out = sess.add(plc, out, a)
        return out
    raise UnimplementedError(f"physical op {kind} ({op.name})")


def _recv_sources(comp: Computation, order) -> dict:
    """Map each Receive op to the env name of its Send's input: in one
    process the received value is the sent value, and no rendezvous
    store is needed."""
    send_of: dict[str, str] = {}
    for n in order:
        op = comp.operations[n]
        if op.kind == "Send":
            send_of[op.attributes["rendezvous_key"]] = op.inputs[0]
    out = {}
    for n in order:
        op = comp.operations[n]
        if op.kind == "Receive":
            out[n] = send_of[op.attributes["rendezvous_key"]]
    return out


def _lift_boundary(arr, op, plc: str, device):
    """Bind an Input's argument or a Load's stored array at the lowered
    op's host type: bits (an AES input's wire array), ring words (a
    lowered LoadShares: uint64 limb planes, ``values.limbs_to_ring``) or
    a float tensor."""
    ret = op.signature.return_type
    if ret.dtype is not None and ret.dtype.is_boolean:
        return HostBitTensor(torch.as_tensor(
            np.asarray(arr).astype(np.uint8), device=device), plc)
    return _lift_array(arr, op, plc, device)


# the session id of the evaluation under way: every session of one
# evaluation (its segments', its per-op chunks') shares it, so the seeds
# an aes-ctr DeriveSeed hashes from it agree across the parties' ops
_SESSION_ID: contextvars.ContextVar = contextvars.ContextVar(
    "physical_session_id", default=None)


def _session(device) -> EagerSession:
    return EagerSession(device, session_id=_SESSION_ID.get())


def _sample_seed(key, plc: str, name: str) -> HostSeed:
    """An unseeded Sample's fresh seed: the key itself, four host words
    (an eager walk's) or a row of a plan's key table, kept on the device
    as a :class:`~moose_tpu_torch.values.DeviceSeed` without a nonce."""
    value = DeviceSeed(key, None) if isinstance(key, torch.Tensor) else key
    return HostSeed(value, plc, origin=(("fresh", name), None))


def _run_physical_ops(sess, comp, names, static_env, env, outputs, saves,
                      keys, dyn, recv_src, trace_ops=False,
                      fault_kinds=frozenset()):
    """Execute the host-level ops ``names`` in order against ``env``:
    shared by the whole-graph core, the segments and the per-op chunks.
    ``keys`` holds each PrfKeyGen's and Sample's key: four host words
    (seeds derived on the host) or a row of the plan's key table (seeds
    made by K7 on the card).  ``dyn`` holds the bound Inputs and Loads (a
    raw array is lifted here); ``fault_kinds`` (self-check candidates
    only) corrupts the results of ops of those kinds
    (``interpreter._fault_kinds``)."""
    for n in names:
        if n in env:
            continue
        op = comp.operations[n]
        plc = comp.placement_of(op).name
        kind = op.kind
        # named in a failed capture's error
        graphs.current_op(n)
        if kind == "Send":
            env[n] = HostUnit(plc)
        elif kind == "Receive":
            env[n] = host.place(env[recv_src[n]], plc)
        elif kind == "PrfKeyGen":
            env[n] = HostPrfKey(keys[n], plc, origin=n)
        elif kind == "Sample":
            # an unseeded draw (reference SampleOp): its fresh seed is a
            # plan input, like a PrfKeyGen key
            env[n] = _sample_from_seed(
                sess, plc, env[op.inputs[0]],
                _sample_seed(keys[n], plc, n),
                op.signature.return_type.name, op.attributes,
            )
        elif kind in ("Input", "Load"):
            value = dyn[n]
            env[n] = value if isinstance(value, _BOUND) else _lift_boundary(
                value, op, plc, sess.device)
        elif kind == "Save":
            key = env[op.inputs[0]]
            if not isinstance(key, HostString):
                raise KernelError(
                    f"Save {n}: key must be a string, found "
                    f"{type(key).__name__}"
                )
            saves[(plc, key.value)] = env[op.inputs[1]]
            env[n] = HostUnit(plc)
        elif kind == "Output":
            env[n] = env[op.inputs[0]]
            # keyed by Output tag like the reference's executor
            # (execution/asynchronous.rs:623); op name when untagged
            outputs[op.attributes.get("tag", n)] = env[n]
        else:
            args = [env[i] for i in op.inputs]
            if trace_ops:
                with op_span(kind, sess.device):
                    env[n] = execute_kernel(sess, op, plc, args)
            else:
                env[n] = execute_kernel(sess, op, plc, args)
            if fault_kinds and kind in fault_kinds:
                env[n] = _fault_perturb(env[n])


# values bound ahead of the walk (Interpreter._bind_dynamic's forms)
_BOUND = (HostTensor, HostBitTensor, HostRingTensor)
_DYNAMIC_SHAPE_KINDS = frozenset({"Select"})


class _PhysicalPlan(NamedTuple):
    """The plan of one (computation, binding) pair, the JAX package's
    5-tuple: the op order, the ops that take fresh key words (PrfKeyGen
    and Sample), the boundary ops bound at each evaluation, the static
    string arguments, and ``fn(keys, dyn) -> (outputs, saves)``.  It does
    not hold the computation: plans are cached weak-keyed on it."""

    order: list
    key_ops: list
    dyn_names: list
    static_env: dict
    fn: Callable


def _build_plan(comp: Computation, arguments: dict, use_jit: bool,
                segment_limit=None, jit_segments: bool = True,
                fault_kinds=frozenset(), device="cpu") -> _PhysicalPlan:
    """The executable of one (computation, binding) pair: the whole graph
    in one session, captured as one CUDA graph on the card when
    ``use_jit`` and ``jit_segments``, or past ``segment_limit`` ops a
    segmented plan (:func:`_build_segmented_physical`).  A graph with a
    dynamic-shape kind (Select) walks eagerly."""
    device = torch.device(device)
    order = comp.toposort_names()
    if any(comp.operations[n].kind in _DYNAMIC_SHAPE_KINDS for n in order):
        use_jit = False
    key_ops = [n for n in order
               if comp.operations[n].kind in ("PrfKeyGen", "Sample")]
    dyn_names: list = []
    static_env: dict = {}
    for n in order:
        op = comp.operations[n]
        if op.kind == "Input":
            val = arguments.get(n)
            if val is None:
                raise MissingArgumentError(f"missing argument {n!r}")
            if isinstance(val, str):
                static_env[n] = HostString(val, comp.placement_of(op).name)
            else:
                dyn_names.append(n)
        elif op.kind == "Load":
            dyn_names.append(n)
    comp_ref = weakref.ref(comp)
    recv_src = _recv_sources(comp, order)
    # per-op spans belong to eager plans, whose ops the host times
    trace_ops = telemetry.trace_ops_enabled() and not use_jit
    limit = segment_limit if segment_limit is not None else _segment_limit()
    if use_jit and len(order) > limit:
        fn = _build_segmented_physical(
            comp_ref, order, static_env, dyn_names, key_ops, recv_src,
            limit, jit_segments, fault_kinds, device)
        return _PhysicalPlan(order, key_ops, dyn_names, static_env, fn)

    def core(keys: dict, dyn: dict):
        comp = comp_ref()
        if comp is None:  # pragma: no cover - defensive
            raise KernelError("computation was garbage-collected")
        sess = _session(device)
        env: dict = dict(static_env)
        outputs: dict = {}
        saves: dict = {}
        _run_physical_ops(sess, comp, order, static_env, env, outputs,
                          saves, keys, dyn, recv_src, trace_ops, fault_kinds)
        return outputs, saves

    fn = _jit(core, "whole graph", device) if use_jit and jit_segments \
        else core
    return _PhysicalPlan(order, key_ops, dyn_names, static_env,
                         _as_segment(fn, len(order)))


def _effective_inputs(comp, recv_src):
    """The dataflow inputs of an op: a Receive reads its Send's input,
    so a transfer is an ordinary boundary value between segments."""

    def inputs(n):
        op = comp.operations[n]
        if op.kind == "Receive":
            return [recv_src[op.name]]
        return op.inputs

    return inputs


def _build_segmented_physical(comp_ref, order, static_env, dyn_names,
                              key_ops, recv_src, limit=None,
                              jit_segments: bool = True,
                              fault_kinds=frozenset(), device="cpu"):
    """The lowered graph's segmentation over the shared orchestrator
    (``interpreter.build_segmented_runner``): each segment one session,
    captured as its own CUDA graph on the card, and given only its own
    PRF keys."""
    comp = comp_ref()
    key_set = set(key_ops)

    def seg_exec(si, names, keys, dyn, env, outputs, saves):
        comp = comp_ref()
        if comp is None:  # pragma: no cover - defensive
            raise KernelError("computation was garbage-collected")
        _run_physical_ops(_session(device), comp, names, static_env,
                          env, outputs, saves, keys, dyn, recv_src, False,
                          fault_kinds)

    # per-segment key narrowing needs the chunking: computed once and
    # handed to the orchestrator
    effective = _effective_inputs(comp, recv_src)
    segmentation = plan_segments(
        order, static_env, effective,
        limit if limit is not None else _segment_limit())
    keys_of = [[n for n in names if n in key_set]
               for names in segmentation[0]]
    return build_segmented_runner(
        order, static_env, dyn_names, effective, limit, jit_segments,
        seg_exec, lambda keys, si: {n: keys[n] for n in keys_of[si]},
        segmentation=segmentation, device=device)


def _physical_plan_builder(comp, arguments, use_jit, segment_limit,
                           jit_segments, fault_kinds=frozenset(),
                           device="cpu"):
    """The ``builder`` hook of the shared ``_SelfCheckRunner``: a lowered
    plan takes every PRF key as an input and bakes its sync keys as
    attributes of the graph, so its eager and captured runs from one key
    table give the same words (no nonce pinning)."""
    plan = _build_plan(comp, arguments, use_jit, segment_limit=segment_limit,
                       jit_segments=jit_segments, fault_kinds=fault_kinds,
                       device=device)
    return plan, plan.fn


# host-boundary and trivial kinds the per-op rung never captures: there is
# nothing to fuse and nothing a divergence could touch
_PER_OP_EAGER_KINDS = frozenset({
    "Input", "Load", "Save", "Output", "Send", "Receive", "PrfKeyGen",
    "Constant", "Identity",
})


def _physical_per_op_builder(comp, arguments, eager_plan, fault_kinds,
                             nonce_seed, pinned=(), device="cpu"):
    """The ``per_op_builder`` hook for lowered plans: each op takes its
    PRF keys as inputs (no nonce pinning) and a Receive reads its Send's
    input as a dataflow edge, so per-op programs compose as segments do.
    Above ``MOOSE_TPU_PEROP_MAX`` ops the rung validates and pins chunks
    of ``max(50, ceil(n / MOOSE_TPU_PEROP_MAX))`` consecutive ops, so a
    large plan keeps only its divergent chunks eager."""
    order, key_ops, dyn_names, static_env, _ = eager_plan
    limit = _per_op_limit()
    if limit <= 0:
        return None
    seg_size = 1
    if len(order) > limit:
        # at least the ladder's finest segment rung, grown until the
        # chunk count fits the cap
        finest = _SelfCheckBase.LADDER[-2]
        seg_size = max(finest, -(-len(order) // limit))
    comp_ref = weakref.ref(comp)
    recv_src = _recv_sources(comp, order)
    key_set = set(key_ops)

    def seg_exec(si, names, keys, dyn, env, outputs, saves,
                 fault=frozenset()):
        comp = comp_ref()
        if comp is None:  # pragma: no cover - defensive
            raise KernelError("computation was garbage-collected")
        _run_physical_ops(_session(device), comp, names, static_env,
                          env, outputs, saves, keys, dyn, recv_src, False,
                          fault)

    always = {n for n in order
              if comp.operations[n].kind in _PER_OP_EAGER_KINDS}
    # the chunking is _PerOpPlan's own (consecutive seg_size slices of
    # the same order), so the per-chunk key narrowing stays aligned
    keys_of = [[n for n in order[i:i + seg_size] if n in key_set]
               for i in range(0, len(order), seg_size)]
    return _PerOpPlan(
        order, static_env, dyn_names, _effective_inputs(comp, recv_src),
        seg_exec, fault_kinds,
        lambda keys, si: {n: keys[n] for n in keys_of[si]},
        always_eager=always, pinned=pinned, seg_size=seg_size,
        device=device)


def plan_keys(key_ops, device, static=None) -> dict:
    """One evaluation's fresh PRF keys as a plan takes them: the rows of
    one ``(len(key_ops), 4)`` int64 key table (``graphs.host_key_table``),
    copied into the plan's static buffer on the card (``static``), so a
    replay reads each evaluation's keys where its capture read the
    first's.  Under ``MOOSE_TPU_FIXED_KEYS`` each key derives from its
    op's name."""
    table = graphs.host_key_table([_fresh_key_words(n) for n in key_ops])
    table = static.put("keys", table) if static is not None \
        else table.to(device)
    return {n: table[i] for i, n in enumerate(key_ops)}


@dataclasses.dataclass
class _CachedPlan:
    """One cached plan: its executable, its static buffers on the card,
    and the lock its evaluations hold from binding the inputs and keys
    to copying the outputs out (a replay overwrites the last one's)."""

    plan: _PhysicalPlan
    fn: Callable
    planned: bool
    static: Any
    lock: Any


class PhysicalInterpreter:
    """Executes lowered computations on ``device``, one plan cached per
    (computation, binding), weak-keyed on the computation.  At
    ``use_jit`` a plan runs as the JAX package's compiled plan: on the
    card captured as CUDA graphs and validated against its eager run on
    its first ``MOOSE_TPU_JIT_SELFCHECK`` evaluations (the shared
    ``_SelfCheckRunner``, plan key ``"physical"``), on the CPU its
    segments uncaptured, validated only under
    ``MOOSE_TPU_SELFCHECK_FORCE=1``.  Without ``use_jit`` the plan walks
    eagerly with host keys, deriving each seed on the host."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._cache = weakref.WeakKeyDictionary()
        self._cache_lock = threading.Lock()
        # the plan of the most recent evaluate(), which the runtime lifts
        # into last_plan: plan_mode, pinned_ops, plan_state, cuda_graphs
        self.last_plan_info: dict = {}

    def _plan_info(self, comp, use_jit, plan, fn) -> dict:
        runner = getattr(fn, "__self__", None)
        if isinstance(runner, _SelfCheckRunner):
            return {"plan_mode": runner.plan_mode,
                    "pinned_ops": runner.pinned_ops,
                    "plan_state": runner.mode}
        if not use_jit or any(comp.operations[n].kind in _DYNAMIC_SHAPE_KINDS
                              for n in plan.order):
            mode = "eager"
        elif len(plan.order) > _segment_limit():
            mode = "segmented"
        else:
            mode = "whole-graph"
        return {"plan_mode": mode, "pinned_ops": [], "plan_state": "static"}

    def _build(self, comp, arguments, use_jit, selfcheck) -> _CachedPlan:
        planned = use_jit or selfcheck
        if selfcheck:
            with telemetry.span("build_plan", n_ops=len(comp.operations)):
                runner = _SelfCheckRunner(
                    comp, arguments, _selfcheck_runs(),
                    builder=_physical_plan_builder, pin_nonces=False,
                    per_op_builder=_physical_per_op_builder,
                    plan_key="physical", device=self.device)
            plan, fn = runner.eager_plan, runner.run
        elif use_jit:
            with telemetry.span("build_plan", n_ops=len(comp.operations)):
                plan = _build_plan(comp, arguments, True, device=self.device)
            fn = plan.fn
        else:
            plan = _build_plan(comp, arguments, False, device=self.device)
            fn = plan.fn
        static = (graphs.StaticInputs(self.device)
                  if planned and self.device.type == "cuda" else None)
        return _CachedPlan(plan, fn, planned, static, threading.RLock())

    def _bind_dynamic(self, comp, plan, arguments, storage, static) -> dict:
        """The plan's Inputs and Loads for one evaluation, each lifted at
        its op's host type; on the card into the plan's static buffers
        through pinned memory."""
        dyn = {}
        on = "cpu" if static is not None else self.device
        for n in plan.dyn_names:
            op = comp.operations[n]
            plc = comp.placement_of(op).name
            if op.kind == "Input":
                arr = arguments[n]
            else:  # Load
                key_op = comp.operations[op.inputs[0]]
                key = key_op.attributes.get("value")
                if key is None:
                    key_val = plan.static_env.get(op.inputs[0])
                    if isinstance(key_val, HostString):
                        key = key_val.value
                store = storage.get(plc, {})
                if key not in store:
                    raise StorageError(
                        f"no value for key {key!r} in storage of {plc!r}"
                    )
                arr = store[key]
            value = _lift_boundary(arr, op, plc, on)
            dyn[n] = static.put(n, value) if static is not None else value
        return dyn

    def evaluate(
        self,
        comp: Computation,
        storage: dict,
        arguments: Optional[dict] = None,
        use_jit: bool = True,
        identity: Optional[str] = None,
    ) -> dict:
        """Run the lowered ``comp`` on ``arguments``; Load and Save read
        and write ``storage``.  ``use_jit`` runs the compiled plan (CUDA
        graphs on the card); its keys are fresh each evaluation."""
        if identity is not None:
            raise NotImplementedError(
                f"the physical executor runs every host in one process; "
                f"one worker's role (identity={identity!r}: its own ops, "
                "Send/Receive over a network) runs through "
                "distributed.worker.execute_role with a networking backend"
            )
        arguments = arguments or {}
        gated = heavy_jit_gate(use_jit, self.device)
        selfcheck = use_jit and not gated and _selfcheck_runs() > 0
        use_jit = gated
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
        session_id = _SESSION_ID.set(secrets.token_hex(8))
        try:
            return self._run(comp, cached, plan, arguments, storage,
                             use_jit)
        finally:
            _SESSION_ID.reset(session_id)

    def _run(self, comp, cached, plan, arguments, storage, use_jit) -> dict:
        with cached.lock:
            with telemetry.span("bind_arguments"):
                dyn = self._bind_dynamic(comp, plan, arguments, storage,
                                         cached.static)
                if cached.planned:
                    keys = plan_keys(plan.key_ops, self.device,
                                     cached.static)
                else:
                    keys = {n: _fresh_key_words(n) for n in plan.key_ops}
            # the span closes once the outputs are numpy on the host, so
            # it covers the device's work
            with telemetry.span("execute", jit=cached.planned) as sp:
                replays = graphs.replays()
                outputs, saves = cached.fn(keys, dyn)
                # the plan's shape after the run: a validating evaluation
                # may have promoted, demoted or pinned
                info = self._plan_info(comp, use_jit, plan, cached.fn)
                info["cuda_graphs"] = graphs.replays() - replays
                self.last_plan_info = info
                sp.attrs["plan_mode"] = info["plan_mode"]
                sp.attrs["pinned_ops"] = len(info["pinned_ops"])
                return Interpreter._copy_out(None, outputs, saves, storage)


# one interpreter a device, as the JAX package keeps its ``_DEFAULT``: a
# graph run again through execute_physical reuses its validated plan
_DEFAULTS: dict = {}
_DEFAULTS_LOCK = threading.Lock()


def default_interpreter(device=devices.DEFAULT_DEVICE) -> PhysicalInterpreter:
    """The process's :class:`PhysicalInterpreter` on ``device``."""
    dev = devices.canonical(devices.resolve(device))
    with _DEFAULTS_LOCK:
        interp = _DEFAULTS.get(dev)
        if interp is None:
            interp = _DEFAULTS[dev] = PhysicalInterpreter(dev)
        return interp


def execute_physical(
    comp: Computation,
    storage: dict,
    arguments: Optional[dict] = None,
    use_jit: bool = True,
    identity: Optional[str] = None,
    device=devices.DEFAULT_DEVICE,
) -> dict:
    """Execute a lowered computation locally: all hosts in one process,
    on ``device`` (the CUDA card unless the caller asks for the CPU),
    through that device's one :class:`PhysicalInterpreter`, which keeps
    each graph's plans."""
    return default_interpreter(device).evaluate(
        comp, storage, arguments, use_jit, identity)
