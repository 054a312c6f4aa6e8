"""Lowering pass: logical placement-ops -> host-level op graph.

The port of ``moose_tpu/compilation/lowering.py``.  Runs every logical
operation through the per-host ``logical.execute_op`` with a
:class:`SymbolicSession` (reference compilation/lowering.rs:4-6, "run the
graph through the SymbolicSession"): the replicated, mirrored and
additive protocol kernels expand into their host-op subgraphs exactly as
they execute, because they are the executing kernels.  Under the same
``deterministic_sync_keys`` seed the port lowers a graph to the JAX
package's bytes.

Boundary ops (Input/Load/Save/Output) are re-emitted verbatim with
host-level types and their source names preserved, so argument binding
and output naming survive lowering.  SaveShares and LoadShares, the
secret-shared checkpoints, expand into ring-typed Save and Load ops on
each party's own storage (:func:`_lower_shares_boundary`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .. import dtypes as dt
from ..computation import (
    AES_TY_NAMES,
    Computation,
    HostPlacement,
    Signature,
    Ty,
)
from ..dialects import logical
from ..errors import CompilationError, MissingArgumentError
from ..execution.symbolic import (
    SymArray,
    SymbolicSession,
    _STRING_TY,
    _UNIT_TY,
    _tensor_ty,
)
from ..values import (
    HostBitTensor,
    HostString,
    HostTensor,
    HostUnit,
    RepFixedTensor,
    RepTensor,
)


class SymString(HostString):
    """A string value during lowering that remembers its producing op."""

    def __init__(self, value: str, plc: str, op: str):
        super().__init__(value, plc)
        self.op = op


def arg_specs_from_arguments(arguments: dict, storage=None, comp=None):
    """Build lowering arg_specs from concrete example arguments (shape +
    dtype per Input, plus Load targets resolved against ``storage``)."""
    specs = {}
    for name, val in (arguments or {}).items():
        if isinstance(val, (str, int, float)):
            specs[name] = val
        else:
            arr = np.asarray(val)
            specs[name] = (tuple(arr.shape), arr.dtype)
    if comp is not None and storage is not None:
        for op in comp.operations.values():
            if op.kind != "Load":
                continue
            key_op = comp.operations[op.inputs[0]]
            key = key_op.attributes.get("value")
            if key is None:
                key = (arguments or {}).get(key_op.name)
            plc = comp.placement_of(op)
            owner = getattr(plc, "name", None)
            store = storage.get(owner, {})
            if key in store:
                arr = np.asarray(store[key])
                specs[op.name] = (tuple(arr.shape), arr.dtype)
    return specs


def _aes_bit_len(ret_name: str) -> int:
    # AesTensor = 96 nonce + 128 ciphertext bits; keys are 128 bits
    return 224 if ret_name == "AesTensor" else 128


def _lift_aes_boundary(sess, comp, op, plc, bits_value, owner: str):
    """Wrap a lowered HostBitTensor boundary value (leading axis = bit
    index) as the AES structure the Decrypt kernels consume — the
    symbolic mirror of ``aes.lift_input`` (the eager boundary), so
    encrypted inputs survive the explicit lowering pipeline and deploy
    to real workers (reference lowers Decrypt like any op,
    encrypted/mod.rs:14-40)."""
    from ..dialects import replicated as rep_ops
    from ..values import AesTensor, HostAesKey, RepAesKey, RepBitArray

    ret = op.signature.return_type
    if ret.name == "AesTensor":
        nonce = sess.strided_slice(owner, bits_value, (slice(0, 96),))
        cipher = sess.strided_slice(owner, bits_value, (slice(96, 224),))
        return AesTensor(nonce, cipher, owner)
    if ret.name in ("AesKey", "HostAesKey", "ReplicatedAesKey"):
        if plc.kind == "Host":
            return HostAesKey(bits_value, owner)
        if plc.kind == "Replicated":
            # cleartext key bits arrive on the first owner and are
            # secret-shared from there, matching aes.lift_input
            shared = rep_ops.share(sess, plc, bits_value)
            return RepAesKey(RepBitArray(shared, 128))
    raise CompilationError(
        f"op {op.name}: cannot lower AES boundary of type {ret.name} "
        f"on {plc.kind} placement"
    )


def _lift_boundary(sess, op, plc_name: str, shape, np_dtype):
    """Emit a host-level boundary op (Input/Load) and wrap its result as a
    symbolic runtime value."""
    ret = op.signature.return_type
    dtype = ret.dtype
    if dtype is not None and dtype.is_fixedpoint:
        raise CompilationError(
            f"op {op.name}: fixed-point host inputs must be loaded as "
            "floats and cast (matches the eager interpreter contract)"
        )
    if dtype is None:
        dtype = dt.from_numpy(np.dtype(np_dtype))
    if dtype.is_boolean:
        host_ty = Ty("HostBitTensor", dt.bool_)
    else:
        host_ty = _tensor_ty(dtype)
    name = sess.add_operation(
        op.kind,
        [],
        plc_name,
        Signature((), host_ty),
        dict(op.attributes),
        name=op.name,
    )
    if dtype.is_boolean:
        return HostBitTensor(SymArray(name, shape), plc_name)
    return HostTensor(SymArray(name, shape), plc_name, dtype)


def share_key(key: str, slot: int) -> str:
    """Party-local storage key of one element of a saved share pair.
    Every party uses the same two keys: ``<key>#s0`` holds x_i (the
    party's own additive share), ``<key>#s1`` holds x_{i+1} (its copy of
    the next party's), so a checkpoint directory is meaningless without
    the other two parties' storages."""
    return f"{key}#s{slot}"


def _shares_of(v):
    """(RepTensor, integral, fractional) of a replicated value."""
    if isinstance(v, RepFixedTensor):
        return v.tensor, v.integral_precision, v.fractional_precision
    if isinstance(v, RepTensor):
        return v, None, None
    raise CompilationError(
        f"expected a replicated sharing, found {type(v).__name__}"
    )


def _lower_shares_boundary(sess, comp, op, plc, env):
    """Expand SaveShares/LoadShares into per-party ring-typed Save/Load
    ops: party i touches only the two ring tensors it already holds
    ((x_i, x_{i+1}) of the 2-of-3 replicated sharing), through its own
    storage, so the checkpointed model never exists in the clear on any
    host.  Op for op the reference's expansion: the per-share ops are
    named ``<op>_p{i}s{slot}`` and the last Save keeps the logical op's
    name, so Output-of-Unit edges keep resolving."""
    from ..execution.symbolic import _ring_ty

    if plc.kind != "Replicated":
        raise CompilationError(
            f"op {op.name}: {op.kind} requires a replicated placement, "
            f"found {plc.kind}"
        )
    key_val = env[op.inputs[0]]
    if not isinstance(key_val, HostString):
        raise CompilationError(
            f"op {op.name}: {op.kind} key must be a string constant "
            "(checkpoint keys must be stable across sessions so "
            "compiled-plan caches hit)"
        )
    key = key_val.value
    ret = op.signature.return_type

    if op.kind == "SaveShares":
        value = logical.to_rep(sess, plc, env[op.inputs[1]])
        rep_tensor, _, _ = _shares_of(value)
        width = rep_tensor.shares[0][0].width
        owners = comp.placements[plc.name].owners
        last = None
        for i, owner in enumerate(owners):
            for slot in (0, 1):
                share = rep_tensor.shares[i][slot]
                key_name = sess._string_const(share_key(key, slot), owner)
                is_last = i == len(owners) - 1 and slot == 1
                sess.add_operation(
                    "Save",
                    [key_name, sess._name_of(share)],
                    owner,
                    Signature((_STRING_TY, _ring_ty(width)), _UNIT_TY),
                    {},
                    name=op.name if is_last else f"{op.name}_p{i}s{slot}",
                )
                last = owner
        return HostUnit(last)

    # LoadShares: reassemble the replicated sharing from each party's
    # own persisted pair; shape and precision are static op metadata
    dtype = ret.dtype
    if dtype is None or not dtype.is_fixedpoint:
        raise CompilationError(
            f"op {op.name}: LoadShares requires a fixed-point return "
            f"dtype, found {dtype!r}"
        )
    shape = tuple(op.attributes["shape"])
    width = 64 if dtype.name == "fixed64" else 128
    shares = []
    for i, owner in enumerate(comp.placements[plc.name].owners):
        pair = []
        for slot in (0, 1):
            key_name = sess._string_const(share_key(key, slot), owner)
            load_name = sess.add_operation(
                "Load",
                [key_name],
                owner,
                Signature((_STRING_TY,), _ring_ty(width)),
                {},
                name=f"{op.name}_p{i}s{slot}",
            )
            pair.append(sess._ring(load_name, shape, width, owner))
        shares.append(tuple(pair))
    return RepFixedTensor(
        RepTensor(tuple(shares), plc.name),
        dtype.integral_precision, dtype.fractional_precision,
    )


def lower(comp: Computation, arg_specs: Optional[dict] = None) -> Computation:
    """Lower a logical computation to a host-level computation."""
    arg_specs = arg_specs or {}
    target = Computation()
    for plc in comp.placements.values():
        if isinstance(plc, HostPlacement):
            target.add_placement(plc)
        else:
            for owner in plc.owners:
                target.add_placement(HostPlacement(owner))

    sess = SymbolicSession(target)
    # Composite-placement lookups (replicated/mirrored owners) resolve
    # against the SOURCE placements.
    logical.bind_placements(sess, comp)

    env: dict = {}
    for name in comp.toposort_names():
        op = comp.operations[name]
        plc = comp.placement_of(op)
        kind = op.kind

        if kind == "Input":
            if op.signature.return_type.name in AES_TY_NAMES:
                spec = arg_specs.get(name)
                if spec is None:
                    raise MissingArgumentError(
                        f"lowering requires a shape spec for AES input "
                        f"{name!r}; pass arg_specs"
                    )
                shape, _np_dtype = spec
                want = _aes_bit_len(op.signature.return_type.name)
                if not shape or shape[0] != want:
                    raise CompilationError(
                        f"AES input {name}: leading axis must be {want} "
                        f"bits, found shape {shape}"
                    )
                owner = (
                    plc.name
                    if isinstance(plc, HostPlacement)
                    else plc.owners[0]
                )
                in_name = sess.add_operation(
                    "Input", [], owner,
                    Signature((), Ty("HostBitTensor", dt.bool_)),
                    dict(op.attributes), name=name,
                )
                bits = HostBitTensor(SymArray(in_name, shape), owner)
                env[name] = _lift_aes_boundary(
                    sess, comp, op, plc, bits, owner
                )
                continue
            spec = arg_specs.get(name)
            if spec is None:
                raise MissingArgumentError(
                    f"lowering requires a shape/dtype spec for input "
                    f"{name!r} (XLA static shapes); pass arg_specs"
                )
            if isinstance(spec, str):
                op_name = sess.add_operation(
                    "Input", [], plc.name, Signature((), _STRING_TY),
                    dict(op.attributes), name=name,
                )
                env[name] = SymString(spec, plc.name, op_name)
            elif isinstance(spec, (int, float)):
                # static scalar: bake as a constant in the lowered graph
                env[name] = spec
            else:
                shape, np_dtype = spec
                env[name] = _lift_boundary(sess, op, plc.name, shape, np_dtype)
            continue

        if kind == "Load":
            if op.signature.return_type.name in AES_TY_NAMES:
                spec = arg_specs.get(name)
                if spec is None:
                    raise MissingArgumentError(
                        f"lowering requires a shape spec for AES Load "
                        f"{name!r}; pass arg_specs"
                    )
                shape, _np_dtype = spec
                want = _aes_bit_len(op.signature.return_type.name)
                if not shape or shape[0] != want:
                    raise CompilationError(
                        f"AES Load {name}: leading axis must be {want} "
                        f"bits, found shape {shape}"
                    )
                owner = (
                    plc.name
                    if isinstance(plc, HostPlacement)
                    else plc.owners[0]
                )
                key_in = sess._name_of(env[op.inputs[0]])
                load_name = sess.add_operation(
                    "Load", [key_in], owner,
                    Signature((_STRING_TY,), Ty("HostBitTensor", dt.bool_)),
                    dict(op.attributes), name=name,
                )
                bits = HostBitTensor(SymArray(load_name, shape), owner)
                env[name] = _lift_aes_boundary(
                    sess, comp, op, plc, bits, owner
                )
                continue
            spec = arg_specs.get(name)
            if spec is None:
                raise MissingArgumentError(
                    f"lowering requires a shape/dtype spec for Load "
                    f"{name!r}; pass arg_specs (resolved against storage)"
                )
            shape, np_dtype = spec
            key_in = sess._name_of(env[op.inputs[0]])
            query_in = (
                [sess._name_of(env[op.inputs[1]])]
                if len(op.inputs) > 1
                else []
            )
            ret = op.signature.return_type
            dtype = ret.dtype or dt.from_numpy(np.dtype(np_dtype))
            host_ty = (
                Ty("HostBitTensor", dt.bool_)
                if dtype.is_boolean
                else _tensor_ty(dtype)
            )
            load_name = sess.add_operation(
                "Load",
                [key_in] + query_in,
                plc.name,
                Signature(
                    tuple([_STRING_TY] * (1 + len(query_in))), host_ty
                ),
                dict(op.attributes),
                name=name,
            )
            if dtype.is_boolean:
                env[name] = HostBitTensor(SymArray(load_name, shape), plc.name)
            else:
                env[name] = HostTensor(
                    SymArray(load_name, shape), plc.name, dtype
                )
            continue

        if kind == "Save":
            key = env[op.inputs[0]]
            value = logical.to_host(sess, plc.name, env[op.inputs[1]])
            from ..values import HostFixedTensor

            if isinstance(value, HostFixedTensor):
                # store decoded floats, matching the eager interpreter's
                # Save convention (_to_user_value)
                value = sess.fixedpoint_decode(plc.name, value)
            sess.add_operation(
                "Save",
                [sess._name_of(key), sess._name_of(value)],
                plc.name,
                Signature((_STRING_TY, sess_ty(value)), _UNIT_TY),
                dict(op.attributes),
                name=name,
            )
            env[name] = HostUnit(plc.name)
            continue

        if kind in ("SaveShares", "LoadShares"):
            env[name] = _lower_shares_boundary(sess, comp, op, plc, env)
            continue

        if kind == "Output":
            value = env[op.inputs[0]]
            if not isinstance(value, HostUnit):
                value = logical.to_host(sess, plc.name, value)
            if isinstance(value, HostUnit):
                # an Output of a Unit (e.g. after Save): keep the dataflow
                # edge to the producing op so pruning retains it.  The
                # Output lands on the unit's OWNER host — a composite
                # placement name (an Output of SaveShares traced under
                # the replicated context) is not executable in the host
                # graph and would make the networking pass synthesize a
                # rendezvous no worker ever serves
                sess.add_operation(
                    "Output", [op.inputs[0]], value.plc,
                    Signature((_UNIT_TY,), _UNIT_TY),
                    dict(op.attributes), name=name,
                )
            else:
                from ..values import HostFixedTensor

                if isinstance(value, HostFixedTensor):
                    # reveal as decoded float for the user, matching the
                    # eager interpreter's output convention
                    value = sess.fixedpoint_decode(plc.name, value)
                sess.add_operation(
                    "Output",
                    [sess._name_of(value)],
                    plc.name,
                    Signature((sess_ty(value),), sess_ty(value)),
                    dict(op.attributes),
                    name=name,
                )
            env[name] = value
            continue

        args = [env[i] for i in op.inputs]
        env[name] = logical.execute_op(sess, comp, op, args)

    return target


def sess_ty(value):
    from ..execution.symbolic import _ty_of

    return _ty_of(value)
