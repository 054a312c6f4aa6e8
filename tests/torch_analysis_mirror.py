"""Holds the port's static analyzer against the JAX package's, call by
call.

:func:`mirror` wraps the analysis entry points a JAX test module imported
(``analyze``, ``lint_check``, the reports, the schedules): each call runs
the JAX function as the test asked, then the port's counterpart on the
same graph carried across as bytes (:func:`port_computation`) and on
the same other arguments, and asserts the two results exactly equal:
every diagnostic (rule, severity, op, placement, message), every report
key and number, the same exception with the same diagnostics.  The JAX
result goes back to the test, which then checks what it always checked.
:data:`MIRRORED` counts the calls held equal.
"""

import dataclasses
import enum
import importlib
import inspect
import itertools
import pickle

import numpy as np
import pytest

# name of an entry point -> its module below ``compilation.analysis``
ENTRY_POINTS = {
    "analyze": "", "lint_check": "", "analyze_secrecy": ".secrecy",
    "analyze_communication": ".communication",
    "analyze_signatures": ".signatures", "analyze_hygiene": ".hygiene",
    "analyze_schedule": ".schedule", "analyze_schedules": ".schedule",
    "analyze_fabric_schedules": ".schedule", "plan_errors": ".schedule",
    "build_role_schedule": ".schedule",
    "reconstruct_schedules": ".schedule", "analyze_cost": ".cost",
    "cost_report": ".cost", "infer_specs": ".cost",
    "payload_bytes": ".cost", "fabric_payload": ".cost",
    "analyze_ranges": ".ranges", "infer_ranges": ".ranges",
    "range_report": ".ranges", "analyze_keystream": ".keystream",
    "keystream_report": ".keystream", "host_draw_counts": ".keystream",
}

MIRRORED = {"calls": 0}


def port_computation(comp):
    """The port's copy of a JAX computation, carried across as bytes:
    pickled, each class unpickled as its port twin (the two packages'
    ``computation`` and ``dtypes`` modules are the same code).  Unlike a
    round trip through the codec, which rebuilds what it reads, this
    keeps a deliberately malformed graph exactly as it was built."""
    return _PortUnpickler.loads(pickle.dumps(comp))


class _PortUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module == "moose_tpu" or module.startswith("moose_tpu."):
            module = "moose_tpu_torch" + module[len("moose_tpu"):]
        return super().find_class(module, name)

    @classmethod
    def loads(cls, data):
        import io

        return cls(io.BytesIO(data)).load()


def to_port(value):
    """A JAX-side argument as the port takes it: computations through
    :func:`port_computation`, the JAX package's dataclasses and enums as
    their port twins, containers element by element."""
    from moose_tpu.computation import Computation

    if isinstance(value, Computation):
        return port_computation(value)
    if isinstance(value, dict):
        return {to_port(k): to_port(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)) and not hasattr(value, "_fields"):
        return type(value)(to_port(v) for v in value)
    module = type(value).__module__
    if module.startswith("moose_tpu.") and (
            dataclasses.is_dataclass(value) or isinstance(value, enum.Enum)):
        return _PortUnpickler.loads(pickle.dumps(value))
    return value


def normalize(value):
    """A result in a form both packages' results compare in: classes by
    name, enums by value, arrays by dtype, shape and bytes."""
    if isinstance(value, SystemExit):
        return ("exit", normalize(value.code))
    if isinstance(value, BaseException):
        return ("raised", type(value).__name__,
                normalize(getattr(value, "diagnostics", None)), str(value))
    if isinstance(value, enum.Enum):
        return (type(value).__name__, normalize(value.value))
    if type(value).__name__ == "Computation":
        return ("Computation", list(value.operations))
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return (type(value).__name__, tuple(
            (f.name, normalize(getattr(value, f.name)))
            for f in dataclasses.fields(value)))
    if isinstance(value, dict):
        return ("dict", tuple(
            (normalize(k), normalize(v)) for k, v in value.items()))
    if isinstance(value, (list, tuple)):
        return (type(value).__name__, tuple(normalize(v) for v in value))
    if isinstance(value, (set, frozenset)):
        return ("set", tuple(sorted(repr(normalize(v)) for v in value)))
    if isinstance(value, np.ndarray):
        return ("ndarray", value.dtype.str, value.shape, value.tobytes())
    if isinstance(value, float):
        return ("float", repr(value))
    return value


def _port_fn(name):
    sub = ENTRY_POINTS[name]
    module = importlib.import_module(
        "moose_tpu_torch.compilation.analysis" + sub)
    return getattr(module, name)


def mirrored(name, jax_fn):
    port_fn = _port_fn(name)

    def call(*args, **kwargs):
        try:
            want = jax_fn(*args, **kwargs)
        except Exception as e:  # noqa: BLE001 - held against the port's
            want_error = e
        else:
            want_error = None
        port_args = [to_port(a) for a in args]
        port_kwargs = {k: to_port(v) for k, v in kwargs.items()}
        try:
            got = normalize(port_fn(*port_args, **port_kwargs))
        except Exception as e:  # noqa: BLE001 - compared below
            got = normalize(e)
        expect = normalize(want_error if want_error is not None else want)
        assert got == expect, f"{name}: the port's result differs"
        MIRRORED["calls"] += 1
        if want_error is not None:
            raise want_error
        return want

    call.__name__ = name
    return call


def mirror(monkeypatch, module):
    """Wrap every analysis entry point where a JAX test can reach it: in
    ``module``'s namespace, in the analysis package (a test's local
    import, the JAX compiler's ``strict`` and ``lint`` pass, the
    trainers' gate) and in its defining submodule (its callers there)."""
    for name, sub in ENTRY_POINTS.items():
        jax_module = importlib.import_module(
            "moose_tpu.compilation.analysis" + sub)
        original = getattr(jax_module, name)
        wrapper = mirrored(name, original)
        monkeypatch.setattr(jax_module, name, wrapper)
        package = importlib.import_module("moose_tpu.compilation.analysis")
        if getattr(package, name, None) is original:
            monkeypatch.setattr(package, name, wrapper)
        if module.__dict__.get(name) is original:
            monkeypatch.setattr(module, name, wrapper)


def mirror_worker_plan(monkeypatch):
    """Wrap the JAX worker plan's get_plan and keystream gate: each call
    also runs the port's (``moose_tpu_torch.distributed.worker_plan``)
    on the same graph, and the ranges advisory of the plan, the gate's
    diagnostics and any refusal must be equal."""
    import moose_tpu.distributed.worker_plan as jwp
    import moose_tpu_torch.distributed.worker_plan as twp

    def wrap(name, view):
        jax_fn, port_fn = getattr(jwp, name), getattr(twp, name)

        def call(comp, *args, **kwargs):
            try:
                want, error = jax_fn(comp, *args, **kwargs), None
            except Exception as e:  # noqa: BLE001 - held against the port's
                error = e
            try:
                got = normalize(view(port_fn(port_computation(comp), *args,
                                             **kwargs)))
            except Exception as e:  # noqa: BLE001 - compared below
                got = normalize(e)
            expect = normalize(error if error is not None else view(want))
            assert got == expect, f"worker_plan.{name}: the port differs"
            MIRRORED["calls"] += 1
            if error is not None:
                raise error
            return want

        monkeypatch.setattr(jwp, name, call)

    wrap("get_plan", lambda plan: plan.ranges_advisory)
    wrap("_keystream_errors", lambda errors: errors)


def _captured(fn, args, kwargs):
    """(result or exception, stdout, stderr) of ``fn``; SystemExit too."""
    import contextlib
    import io

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            result = fn(*args, **kwargs)
        except BaseException as e:  # noqa: BLE001 - a CLI exits
            result = e
    return result, out.getvalue(), err.getvalue()


def mirror_cli(monkeypatch):
    """Wrap the JAX prancer's ``main`` and flag parsers: each call runs
    both CLIs on the same arguments and files, and their standard output,
    standard error and exit code (or parsed flags) must be equal; the
    JAX CLI's output then goes where the test reads it."""
    import sys

    import moose_tpu.bin.prancer as jprancer
    import moose_tpu_torch.bin.prancer as tprancer

    for name in ("main", "_parse_arg_ranges", "_parse_arg_shapes"):
        jax_fn, port_fn = getattr(jprancer, name), getattr(tprancer, name)

        def call(*args, _jax_fn=jax_fn, _port_fn=port_fn, _name=name,
                 **kwargs):
            want = _captured(_jax_fn, args, kwargs)
            got = _captured(_port_fn, args, kwargs)
            assert normalize(got) == normalize(want), (
                f"prancer {_name}: the port's CLI differs")
            MIRRORED["calls"] += 1
            result, out, err = want
            sys.stdout.write(out)
            sys.stderr.write(err)
            if isinstance(result, BaseException):
                raise result
            return result

        monkeypatch.setattr(jprancer, name, call)


def cases(module, skip=()):
    """``pytest.param``s of every test function of ``module`` and each
    of its parametrizations, as (function name, keyword arguments); a
    parametrization the JAX file marks slow is marked slow here too."""
    out = []
    for name, fn in vars(module).items():
        if not name.startswith("test_") or not inspect.isfunction(fn):
            continue
        if name in skip:
            continue
        marks = [m for m in getattr(fn, "pytestmark", [])
                 if m.name == "parametrize"]
        axes = []
        for mark in reversed(marks):
            argnames = mark.args[0]
            if isinstance(argnames, str):
                argnames = [a.strip() for a in argnames.split(",")]
            values = []
            for v in mark.args[1]:
                if hasattr(v, "values") and hasattr(v, "marks"):
                    slow = any(m.name == "slow" for m in v.marks)
                    vals, ident = v.values, v.id
                else:
                    slow = False
                    vals = v if len(argnames) > 1 else (v,)
                    ident = None
                values.append((dict(zip(argnames, vals)), slow, ident))
            axes.append(values)
        for combo in itertools.product(*axes) if axes else [()]:
            params, slow, ids = {}, False, []
            for kwargs, is_slow, ident in combo:
                params.update(kwargs)
                slow = slow or is_slow
                ids.append(ident or "-".join(
                    getattr(v, "name", None) or str(v)
                    for v in kwargs.values()))
            case_id = name + ("[" + "-".join(ids) + "]" if ids else "")
            out.append(pytest.param(
                name, params, id=case_id,
                marks=(pytest.mark.slow,) if slow else ()))
    return out


def run_case(module, name, params, request):
    """Run one JAX test function with its parametrization and the
    fixtures it asks for; returns how many of its analysis calls were
    held equal."""
    fn = getattr(module, name)
    kwargs = dict(params)
    for arg in inspect.signature(fn).parameters:
        if arg not in kwargs:
            kwargs[arg] = request.getfixturevalue(arg)
    before = MIRRORED["calls"]
    fn(**kwargs)
    return MIRRORED["calls"] - before
