"""elk_compiler: compile serialized computations (reference
``pymoose/src/bindings.rs:403-419`` exposes the Rust compiler to Python as
``elk_compiler.compile_computation(bytes, passes)``).

The port's own copy of ``moose_tpu/elk_compiler.py``: a thin adapter over
:mod:`moose_tpu_torch.compilation`, bytes in, bytes out."""

from __future__ import annotations

from typing import Optional


def compile_computation(comp_bin: bytes, passes: Optional[list] = None,
                        arg_specs: Optional[dict] = None,
                        strict: bool = False) -> bytes:
    """Deserialize a msgpack computation, run compiler passes, and return
    the compiled computation re-serialized; the bytes feed
    ``LocalMooseRuntime.evaluate_compiled`` directly.

    ``arg_specs`` supplies the static shapes the lowering pass needs:
    ``{input_name: ((shape...), np_dtype)}``.  Passes that require no
    shapes (typing, prune, toposort, wellformed, lint, dot, dump) work
    without it.

    ``strict=True`` runs the static analyzer after the passes and raises
    :class:`~moose_tpu_torch.errors.MalformedComputationError` on any
    error-severity diagnostic (share leak, unpaired rendezvous,
    signature mismatch, ...)."""
    from .compilation import compile_computation as _compile
    from .serde import deserialize_computation, serialize_computation

    comp = deserialize_computation(comp_bin)
    compiled = _compile(
        comp, passes=passes, arg_specs=arg_specs, strict=strict
    )
    return serialize_computation(compiled)
