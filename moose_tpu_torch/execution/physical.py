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

On the card a host ring Dot launches K1 in its product-only mode, a host
ring Mul K4 and every SampleSeeded one K7 draw; the lowered graph holds
no fused protocol step, so K2, K3, K5 and K6 do not run here.

Not ported: the JAX package's ``jax.jit`` plans (whole-graph, segmented
and per-op, with their self-checks).  PyTorch runs the plan eagerly at
any ``use_jit``, which is recorded.  The distributed mode, where a worker
runs its own ops and Send/Receive go over the networking backend, is
ROADMAP queue 1, item 12.
"""

from __future__ import annotations

import os
import secrets
import weakref
from typing import Any, Optional

import numpy as np
import torch

from .. import devices
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
    HostBitTensor,
    HostPrfKey,
    HostRingTensor,
    HostSeed,
    HostShape,
    HostString,
    HostUnit,
)
from .interpreter import (
    _lift_array,
    _save_user_value,
    _to_user_value,
    binding_cache_key,
    master_key_words,
    ordered_output_names,
)
from .session import EagerSession

_DISTRIBUTED = "ROADMAP queue 1, item 12"


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
            return HostBitTensor(torch.as_tensor(
                np.asarray(value).astype(np.uint8), device=sess.device), plc)
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


def _run_physical_ops(sess, comp, order, env, outputs, saves, keys, dyn,
                      recv_src):
    """Execute the host-level ops of ``order`` against ``env``."""
    for n in order:
        if n in env:
            continue
        op = comp.operations[n]
        plc = comp.placement_of(op).name
        kind = op.kind
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
                HostSeed(keys[n], plc, origin=(("fresh", n), None)),
                op.signature.return_type.name, op.attributes,
            )
        elif kind in ("Input", "Load"):
            env[n] = _lift_boundary(dyn[n], op, plc, sess.device)
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
            env[n] = execute_kernel(
                sess, op, plc, [env[i] for i in op.inputs])


class _Plan:
    """The resolved plan of one (computation, binding) pair: the op
    order, the ops that take fresh key words, the boundary ops bound at
    each evaluation, the static string arguments and the Receive
    sources."""

    def __init__(self, comp: Computation, arguments: dict):
        self.order = comp.toposort_names()
        self.key_ops = [
            n for n in self.order
            if comp.operations[n].kind in ("PrfKeyGen", "Sample")
        ]
        self.dyn_names: list[str] = []
        self.static_env: dict[str, Any] = {}
        for n in self.order:
            op = comp.operations[n]
            if op.kind == "Input":
                val = arguments.get(n)
                if val is None:
                    raise MissingArgumentError(f"missing argument {n!r}")
                if isinstance(val, str):
                    self.static_env[n] = HostString(
                        val, comp.placement_of(op).name)
                else:
                    self.dyn_names.append(n)
            elif op.kind == "Load":
                self.dyn_names.append(n)
        self.recv_src = _recv_sources(comp, self.order)


class PhysicalInterpreter:
    """Executes lowered computations on ``device``, one plan cached per
    (computation, binding), weak-keyed on the computation object."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._cache = weakref.WeakKeyDictionary()
        # the plan of the most recent evaluate(), which the runtime
        # lifts into last_plan: always eager in the port
        self.last_plan_info: dict = {}

    def evaluate(
        self,
        comp: Computation,
        storage: dict,
        arguments: Optional[dict] = None,
        use_jit: bool = True,
        identity: Optional[str] = None,
    ) -> dict:
        """Run the lowered ``comp`` on ``arguments``; Load and Save read
        and write ``storage``.  ``use_jit`` is the JAX package's switch,
        recorded: the plan runs eagerly either way."""
        if identity is not None:
            raise NotImplementedError(
                f"the physical executor's distributed mode (identity="
                f"{identity!r}: one worker's ops, Send/Receive over the "
                f"network) is {_DISTRIBUTED}"
            )
        arguments = arguments or {}
        per_comp = self._cache.get(comp)
        if per_comp is None:
            per_comp = self._cache[comp] = {}
        cache_key = binding_cache_key(arguments, use_jit)
        plan = per_comp.get(cache_key)
        if plan is None:
            plan = per_comp[cache_key] = _Plan(comp, arguments)

        dyn = {}
        for n in plan.dyn_names:
            op = comp.operations[n]
            if op.kind == "Input":
                dyn[n] = arguments[n]
                continue
            key_op = comp.operations[op.inputs[0]]
            key = key_op.attributes.get("value")
            if key is None:
                key_val = plan.static_env.get(op.inputs[0])
                if isinstance(key_val, HostString):
                    key = key_val.value
            plc = comp.placement_of(op).name
            store = storage.get(plc, {})
            if key not in store:
                raise StorageError(
                    f"no value for key {key!r} in storage of {plc!r}"
                )
            dyn[n] = store[key]

        keys = {n: _fresh_key_words(n) for n in plan.key_ops}
        sess = EagerSession(self.device)
        env: dict[str, Any] = dict(plan.static_env)
        outputs: dict[str, Any] = {}
        saves: dict[tuple, Any] = {}
        _run_physical_ops(sess, comp, plan.order, env, outputs, saves, keys,
                          dyn, plan.recv_src)
        self.last_plan_info = {"plan_mode": "eager", "pinned_ops": [],
                               "plan_state": "static"}
        for (plc_name, key), value in saves.items():
            storage.setdefault(plc_name, {})[key] = _save_user_value(
                sess, value)
        return {
            name: _to_user_value(sess, outputs[name])
            for name in ordered_output_names(outputs)
        }


def execute_physical(
    comp: Computation,
    storage: dict,
    arguments: Optional[dict] = None,
    use_jit: bool = True,
    identity: Optional[str] = None,
    device=devices.DEFAULT_DEVICE,
) -> dict:
    """Execute a lowered computation locally: all hosts in one process,
    on ``device`` (the CUDA card unless the caller asks for the CPU).  A
    caller that runs one graph many times keeps a
    :class:`PhysicalInterpreter`, which keeps its plans."""
    return PhysicalInterpreter(devices.resolve(device)).evaluate(
        comp, storage, arguments, use_jit, identity)
