"""The port's logical compiler passes (``moose_tpu_torch/compilation/``),
``elk_compiler`` and the ``elk`` CLI against the JAX package's, on the CPU.

Counterparts of tests/test_compiler.py's prune, networking, typing,
well-formedness and DOT tests: each graph is built alike in both
packages, and each pass's output in the port is held to the JAX pass's
output on the same graph through the serialized bytes (errors through
their class and message).  The lowering pass is held to the JAX one in
tests/test_torch_lowering.py; the analyzer behind lint and strict, which
the port does not have, raises, naming its ROADMAP item."""

import importlib
import subprocess
import sys
from pathlib import Path

import pytest

from moose_tpu import elk_compiler as jelk
from moose_tpu import serde as jserde
from moose_tpu.bin import elk as jelk_cli
from moose_tpu.compilation import compile_computation as jcompile
from moose_tpu.compilation.networking import networking_pass as jnetworking
from moose_tpu.compilation.pruning import prune as jprune
from moose_tpu.compilation.print import to_dot as jto_dot
from moose_tpu.compilation.typing import typing_pass as jtyping
from moose_tpu.compilation.well_formed import (
    well_formed_check as jwell_formed,
)

from moose_tpu_torch import elk_compiler as telk
from moose_tpu_torch import serde as tserde
from moose_tpu_torch import textual as ttextual
from moose_tpu_torch.compilation import (
    DEFAULT_PASSES,
    compile_computation as tcompile,
)
from moose_tpu_torch.compilation.networking import (
    networking_pass as tnetworking,
)
from moose_tpu_torch.compilation.pruning import (
    prune as tprune,
    reachable_from_roots,
)
from moose_tpu_torch.compilation.print import to_dot as tto_dot
from moose_tpu_torch.compilation.toposort import toposort_pass
from moose_tpu_torch.compilation.typing import typing_pass as ttyping
from moose_tpu_torch.compilation.well_formed import (
    rendezvous_attr_problems,
    well_formed_check as twell_formed,
)
from moose_tpu_torch.errors import CompilationError

from torch_parity import GRAPH_NAMES, traced_pair

REPO = Path(__file__).resolve().parent.parent
# each package's IR module (the packages' own `computation` names the
# eDSL decorator)
IR = tuple(importlib.import_module(f"{p}.computation")
           for p in ("moose_tpu", "moose_tpu_torch"))


# graphs of tests/test_compiler.py, built with either package's IR module


def _manual(c):
    """x -> y = x+x -> output, plus a dangling op to prune."""
    f64 = c.HostFloat64TensorTy
    comp = c.Computation()
    comp.add_placement(c.HostPlacement("alice"))
    comp.add_placement(c.HostPlacement("bob"))
    comp.add_operation(c.Operation("x", "Input", [], "alice",
                                   c.Signature((), f64)))
    for name in ("y", "dangling"):
        comp.add_operation(c.Operation(name, "Add", ["x", "x"], "alice",
                                       c.Signature((f64,) * 2, f64)))
    comp.add_operation(c.Operation("out", "Output", ["y"], "bob",
                                   c.Signature((f64,), f64)))
    return comp


def _squatters(c):
    """User ops named like the networking pass's first Send/Receive."""
    f64 = c.HostFloat64TensorTy
    two = c.Signature((f64,) * 2, f64)
    comp = c.Computation()
    comp.add_placement(c.HostPlacement("alice"))
    comp.add_placement(c.HostPlacement("bob"))
    comp.add_operation(c.Operation("x", "Input", [], "alice",
                                   c.Signature((), f64)))
    comp.add_operation(c.Operation("send_0", "Add", ["x", "x"], "alice",
                                   two))
    comp.add_operation(c.Operation("receive_0", "Mul", ["x", "x"], "alice",
                                   two))
    comp.add_operation(c.Operation("out", "Output", ["send_0"], "bob",
                                   c.Signature((f64,), f64)))
    return comp


def _two_destinations(c):
    """One value consumed on two hosts."""
    f64 = c.HostFloat64TensorTy
    one = c.Signature((f64,), f64)
    comp = c.Computation()
    for name in ("alice", "bob", "carole"):
        comp.add_placement(c.HostPlacement(name))
    comp.add_operation(c.Operation("x", "Input", [], "alice",
                                   c.Signature((), f64)))
    comp.add_operation(c.Operation("out_b", "Output", ["x"], "bob", one))
    comp.add_operation(c.Operation("out_c", "Output", ["x"], "carole", one))
    return comp


def _two_consumers(c):
    """One value consumed twice on one other host."""
    f64 = c.HostFloat64TensorTy
    two = c.Signature((f64,) * 2, f64)
    comp = c.Computation()
    comp.add_placement(c.HostPlacement("alice"))
    comp.add_placement(c.HostPlacement("bob"))
    comp.add_operation(c.Operation("x", "Input", [], "alice",
                                   c.Signature((), f64)))
    comp.add_operation(c.Operation("a", "Add", ["x", "x"], "bob", two))
    comp.add_operation(c.Operation("b", "Mul", ["x", "x"], "bob", two))
    for out, src in (("out", "a"), ("out2", "b")):
        comp.add_operation(c.Operation(out, "Output", [src], "bob",
                                       c.Signature((f64,), f64)))
    return comp


def _both(build):
    return tuple(build(c) for c in IR)


def _same_bytes(jgraph, tgraph):
    assert tserde.serialize_computation(tgraph) == \
        jserde.serialize_computation(jgraph)


def _same_error(jax_call, port_call):
    """Both calls raise the same class of error with the same message."""
    with pytest.raises(Exception) as jerr:
        jax_call()
    with pytest.raises(Exception) as terr:
        port_call()
    assert type(terr.value).__name__ == type(jerr.value).__name__
    assert str(terr.value) == str(jerr.value)
    return terr.value


def test_prune_drops_unreachable():
    jgraph, tgraph = _both(_manual)
    pruned = tprune(tgraph)
    assert set(pruned.operations) == {"x", "y", "out"}
    assert reachable_from_roots(tgraph) == {"x", "y", "out"}
    _same_bytes(jprune(jgraph), pruned)


@pytest.mark.parametrize("build", (_manual, _squatters, _two_destinations,
                                   _two_consumers),
                         ids=("send_receive_pair", "name_collision",
                              "separate_sends_per_destination",
                              "dedupes_per_destination"))
def test_networking_matches_the_jax_pass(build):
    jgraph, tgraph = _both(build)
    if build is _manual:
        jgraph, tgraph = jprune(jgraph), tprune(tgraph)
    netted = tnetworking(tgraph)
    _same_bytes(jnetworking(jgraph), netted)
    twell_formed(netted)
    sends = [o for o in netted.operations.values() if o.kind == "Send"]
    recvs = [o for o in netted.operations.values() if o.kind == "Receive"]
    assert len(sends) == len(recvs) == (2 if build is _two_destinations
                                        else 1)
    order = netted.toposort_names()
    for send in sends:
        recv = next(r for r in recvs if r.attributes["rendezvous_key"]
                    == send.attributes["rendezvous_key"])
        assert order.index(send.name) < order.index(recv.name)
    if build is _squatters:
        assert netted.operations["send_0"].kind == "Add"
        assert netted.operations["receive_0"].kind == "Mul"


def test_networking_refuses_a_logical_graph_as_the_jax_pass_does():
    jgraph, tgraph = traced_pair("logreg")
    err = _same_error(lambda: jnetworking(jgraph),
                      lambda: tnetworking(tgraph))
    assert isinstance(err, CompilationError)
    assert "requires a lowered (host-only) graph" in str(err)


def test_typing_pass_unknown_producer():
    def build(c):
        f64 = c.HostFloat64TensorTy
        comp = c.Computation()
        comp.add_placement(c.HostPlacement("alice"))
        comp.add_operation(c.Operation(
            "y", "Add", ["ghost", "ghost"], "alice",
            c.Signature((f64,) * 2, f64)))
        return comp

    jgraph, tgraph = _both(build)
    err = _same_error(lambda: jtyping(jgraph), lambda: ttyping(tgraph))
    assert "y depends on unknown op ghost" in str(err)


def test_typing_and_toposort_match_the_jax_passes_on_a_traced_graph():
    jgraph, tgraph = traced_pair("logreg")
    _same_bytes(jtyping(jgraph), ttyping(tgraph))
    _same_bytes(jcompile(jgraph, ["toposort"]), toposort_pass(tgraph))


def test_well_formed_cycle_detection_message():
    def build(c):
        f64 = c.HostFloat64TensorTy
        two = c.Signature((f64,) * 2, f64)
        comp = c.Computation()
        comp.add_placement(c.HostPlacement("alice"))
        comp.add_operation(c.Operation("a", "Add", ["b", "b"], "alice", two))
        comp.add_operation(c.Operation("b", "Add", ["a", "a"], "alice", two))
        return comp

    jgraph, tgraph = _both(build)
    err = _same_error(lambda: jwell_formed(jgraph),
                      lambda: twell_formed(tgraph))
    assert "cycle" in str(err)


@pytest.mark.parametrize("case,match", (
    ("send without key", "missing attribute 'rendezvous_key'"),
    ("receive without sender", "missing attribute 'sender'"),
    ("unknown receiver", "'mallory' is not a placement"),
    ("correct pair", None),
))
def test_well_formed_send_receive_attributes(case, match):
    def build(c):
        f64 = c.HostFloat64TensorTy
        comp = c.Computation()
        comp.add_placement(c.HostPlacement("alice"))
        comp.add_placement(c.HostPlacement("bob"))
        comp.add_operation(c.Operation("x", "Input", [], "alice",
                                       c.Signature((), f64)))
        send = c.Signature((f64,), c.UnitTy)
        if case == "send without key":
            comp.add_operation(c.Operation("s", "Send", ["x"], "alice",
                                           send, {"receiver": "bob"}))
        elif case == "receive without sender":
            comp.add_operation(c.Operation(
                "r", "Receive", [], "bob", c.Signature((), f64),
                {"rendezvous_key": "aa"}))
        else:
            receiver = "mallory" if case == "unknown receiver" else "bob"
            comp.add_operation(c.Operation(
                "s", "Send", ["x"], "alice", send,
                {"rendezvous_key": "aa", "receiver": receiver}))
            comp.add_operation(c.Operation(
                "r", "Receive", [], "bob", c.Signature((), f64),
                {"rendezvous_key": "aa", "sender": "alice"}))
        return comp

    jgraph, tgraph = _both(build)
    if match is None:
        assert twell_formed(tgraph) is tgraph
        jwell_formed(jgraph)
        assert all(not rendezvous_attr_problems(op, tgraph.placements)
                   for op in tgraph.operations.values()
                   if op.kind in ("Send", "Receive"))
        return
    err = _same_error(lambda: jwell_formed(jgraph),
                      lambda: twell_formed(tgraph))
    assert match in str(err)


@pytest.mark.parametrize("tags,match", (
    (("y", "y"), "duplicate Output tag 'y'"),
    ((None, "out_a"), "duplicate Output tag 'out_a'"),
    (("y0", "y1"), None),
))
def test_well_formed_output_tags(tags, match):
    def build(c):
        f64 = c.HostFloat64TensorTy
        one = c.Signature((f64,), f64)
        comp = c.Computation()
        comp.add_placement(c.HostPlacement("alice"))
        comp.add_operation(c.Operation("x", "Input", [], "alice",
                                       c.Signature((), f64)))
        for name, tag in zip(("out_a", "out_b"), tags):
            comp.add_operation(c.Operation(
                name, "Output", ["x"], "alice", one,
                {} if tag is None else {"tag": tag}))
        return comp

    jgraph, tgraph = _both(build)
    if match is None:
        twell_formed(tgraph)
        jwell_formed(jgraph)
        return
    err = _same_error(lambda: jwell_formed(jgraph),
                      lambda: twell_formed(tgraph))
    assert match in str(err)


def test_prune_unknown_input_raises_malformed():
    def build(c):
        f64 = c.HostFloat64TensorTy
        comp = c.Computation()
        comp.add_placement(c.HostPlacement("alice"))
        comp.add_operation(c.Operation("out", "Output", ["ghost"], "alice",
                                       c.Signature((f64,), f64)))
        return comp

    jgraph, tgraph = _both(build)
    err = _same_error(lambda: jprune(jgraph), lambda: tprune(tgraph))
    assert "'out': input 'ghost' does not exist" in str(err)


def test_dot_export_renders_the_jax_package_s_graph(capsys):
    jgraph, tgraph = _both(_manual)
    dot = tto_dot(tgraph)
    assert dot == jto_dot(jgraph)
    assert '"y" [label="y = Add"]' in dot and '"x" -> "y";' in dot
    out = tcompile(tgraph, passes=["dot"])
    assert out is tgraph
    assert capsys.readouterr().out == dot + "\n"
    jtraced, ttraced = traced_pair("resnet")
    assert tto_dot(ttraced) == jto_dot(jtraced)


def test_dump_pass_prints_the_text(capsys):
    _, tgraph = traced_pair("logreg")
    assert tcompile(tgraph, passes=["dump"]) is tgraph
    assert capsys.readouterr().out == ttextual.to_textual(tgraph) + "\n"


def test_callable_passes_run_as_in_the_jax_package():
    seen = []
    _, tgraph = _both(_manual)
    assert tcompile(tgraph, passes=[seen.append]) is tgraph
    assert seen == [tgraph]
    pruned = tcompile(tgraph, passes=[tprune])
    assert set(pruned.operations) == {"x", "y", "out"}
    with pytest.raises(CompilationError, match="unknown compiler pass"):
        tcompile(tgraph, passes=["nope"])


@pytest.mark.parametrize("name", GRAPH_NAMES)
def test_elk_compiler_matches_the_jax_package_s_bytes(name):
    """Bytes in, the logical passes, bytes out: equal in both packages."""
    passes = ["typing", "prune", "toposort", "wellformed"]
    _, ttraced = traced_pair(name)
    blob = tserde.serialize_computation(ttraced)
    assert telk.compile_computation(blob, passes) == \
        jelk.compile_computation(blob, passes)


@pytest.mark.parametrize("how,item", (
    (dict(passes=DEFAULT_PASSES), None),
    (dict(passes=["typing", "lowering"]), None),
    (dict(passes=["lint"]), "item 13"),
    (dict(passes=["typing"], strict=True), "item 13"),
))
def test_unported_passes_raise_naming_their_item(how, item):
    """The analyzer's passes raise, naming item 13; the lowering passes,
    ported, give the JAX package's bytes under pinned nonces, through
    ``compile_computation`` and ``elk_compiler`` alike."""
    from moose_tpu.dialects import host as jhost
    from moose_tpu_torch.dialects import host as thost

    jtraced, ttraced = traced_pair("logreg")
    blob = tserde.serialize_computation(ttraced)
    if item is not None:
        with pytest.raises(NotImplementedError, match=item):
            tcompile(ttraced, **how)
        with pytest.raises(NotImplementedError, match=item):
            telk.compile_computation(blob, **how)
    else:
        specs = {"x": ((8, 5), "float64")}
        with thost.deterministic_sync_keys(14):
            got = tserde.serialize_computation(
                tcompile(ttraced, arg_specs=specs, **how))
        with thost.deterministic_sync_keys(14):
            got_blob = telk.compile_computation(blob, arg_specs=specs,
                                                **how)
        with jhost.deterministic_sync_keys(14):
            want = jserde.serialize_computation(
                jcompile(jtraced, arg_specs=specs, **how))
        assert got == want and got_blob == want
    # no pass runs in their place: the default is the JAX package's list
    assert DEFAULT_PASSES == ["typing", "lowering", "prune", "networking",
                              "toposort"]


def _port_elk(*argv):
    return subprocess.run(
        [sys.executable, "-m", "moose_tpu_torch.bin.elk", *argv],
        cwd=REPO, capture_output=True, check=True, timeout=300,
    ).stdout


def test_elk_cli_matches_the_jax_package_s(tmp_path, capsysbinary):
    """``python -m moose_tpu_torch.bin.elk`` on one file gives the bytes
    and the output ``moose_tpu.bin.elk`` gives (the JAX CLI run in this
    process)."""
    _, ttraced = traced_pair("logreg")
    src = tmp_path / "logreg.moose"
    src.write_text(ttextual.to_textual(ttraced))
    for fmt in ("msgpack", "textual", "dot"):
        port_out, jax_out = tmp_path / f"port.{fmt}", tmp_path / f"jax.{fmt}"
        args = ["compile", str(src), "--passes",
                "typing,prune,toposort,wellformed", "--format", fmt]
        _port_elk(*args, "-o", str(port_out))
        jelk_cli.main(args + ["-o", str(jax_out)])
        assert port_out.read_bytes() == jax_out.read_bytes(), fmt
    # no passes: a format conversion to stdout
    jelk_cli.main(["compile", str(src), "--format", "msgpack"])
    assert _port_elk("compile", str(src), "--format", "msgpack") == \
        capsysbinary.readouterr().out
    for metric in ("op_hist", "op_count", "out_degree"):
        jelk_cli.main(["stats", metric, str(src)])
        assert _port_elk("stats", metric, str(src)) == \
            capsysbinary.readouterr().out, metric


def test_elk_cli_passes_arg_specs_on_to_the_lowering_pass(tmp_path):
    """``elk compile --passes typing,lowering --arg-specs`` lowers as the
    JAX CLI lowers: the same graph, whose DeriveSeed sync keys alone
    differ (each lowering draws its own nonces)."""
    _, ttraced = traced_pair("secure_dot")
    src = tmp_path / "dot.bin"
    src.write_bytes(tserde.serialize_computation(ttraced))
    specs = tmp_path / "specs.json"
    specs.write_text('{"x": [[2, 2], "float64"], "y": [[2, 2], "float64"]}')
    args = ["compile", str(src), "--passes", "typing,lowering",
            "--arg-specs", str(specs)]
    _port_elk(*args, "-o", str(tmp_path / "port.bin"))
    jelk_cli.main(args + ["-o", str(tmp_path / "jax.bin")])
    got = tserde.load_computation(str(tmp_path / "port.bin"))
    want = jserde.load_computation(str(tmp_path / "jax.bin"))
    assert [(op.name, op.kind, op.inputs, op.placement_name)
            for op in got.operations.values()] == \
        [(op.name, op.kind, op.inputs, op.placement_name)
         for op in want.operations.values()]
    seeds = 0
    for op in want.operations.values():
        mine = got.operations[op.name]
        assert mine.signature.to_textual() == op.signature.to_textual()
        if op.kind == "DeriveSeed":
            seeds += 1
            continue
        assert tserde.serialize_computation(_only(got, op.name)) == \
            jserde.serialize_computation(_only(want, op.name)), op.name
    assert seeds > 0


def _only(comp, name):
    """A graph of ``comp``'s one op ``name``, for comparing its bytes."""
    c = IR[0] if type(comp).__module__.startswith("moose_tpu.") else IR[1]
    one = c.Computation()
    op = comp.operations[name]
    one.add_placement(comp.placements[op.placement_name])
    one.add_operation(op)
    return one


def test_logger_is_the_port_s_own():
    import logging

    from moose_tpu.logger import get_logger as jget_logger
    from moose_tpu_torch import logger

    log = logger.get_logger()
    assert log.name == "moose_tpu_torch" and log is not jget_logger()
    saved = (log.level, list(log.handlers))
    try:
        assert logger.set_verbose() is log and log.level == logging.DEBUG
        handlers = list(log.handlers)
        logger.set_verbose(False)
        assert log.level == logging.INFO and log.handlers == handlers
    finally:
        log.setLevel(saved[0])
        log.handlers[:] = saved[1]


def test_elk_compiler_is_a_lazy_top_level_name():
    import moose_tpu_torch

    assert "elk_compiler" in moose_tpu_torch.__all__
    assert moose_tpu_torch.elk_compiler is telk
