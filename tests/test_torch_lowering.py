"""The port's lowering pass against the JAX package's: inside each
package's own ``deterministic_sync_keys(seed)``, the port's
``compile_computation(traced, DEFAULT_PASSES + ["wellformed"],
arg_specs)`` serializes to the JAX package's bytes, for the five graphs
of tests/test_compiler.py's lowering tests, config 3's logistic
regression at 8 x 5, a softmax head, a small convolution and a host
Select, and for a host and a replicated Decrypt;
``arg_specs_from_arguments`` gives the same specs.  Each graph is
lowered once a module (``lowered``).

Without pinned nonces two lowerings differ in their DeriveSeed sync
keys, in the JAX package too."""

import numpy as np
import pytest

import moose_tpu as jm
from moose_tpu import serde as jserde
from moose_tpu.compilation import DEFAULT_PASSES as JAX_DEFAULT_PASSES
from moose_tpu.compilation import compile_computation as jcompile
from moose_tpu.compilation.lowering import (
    arg_specs_from_arguments as jspecs,
)
from moose_tpu.dialects import host as jhost
from moose_tpu.edsl import tracer as jtracer

import moose_tpu_torch as tm
from moose_tpu_torch import serde as tserde
from moose_tpu_torch.compilation import DEFAULT_PASSES, compile_computation
from moose_tpu_torch.compilation.lowering import arg_specs_from_arguments
from moose_tpu_torch.dialects import host as thost
from moose_tpu_torch.edsl import tracer as ttracer

from torch_parity import (
    LOWERING_GRAPHS,
    load_chip_smoke,
    lowered_pair,
    lowering_case,
)


@pytest.fixture(scope="module")
def lowered():
    """Each lowering graph lowered by both packages, and serialized."""
    out = {}
    for name in LOWERING_GRAPHS:
        jl, tl, args, storage = lowered_pair(name)
        out[name] = (jserde.serialize_computation(jl),
                     tserde.serialize_computation(tl), jl, tl)
    return out


@pytest.mark.parametrize("name", LOWERING_GRAPHS)
def test_lowered_graph_is_the_jax_package_s_bytes(lowered, name):
    jbytes, tbytes, jl, tl = lowered[name]
    assert [(op.name, op.kind) for op in tl.operations.values()] == \
        [(op.name, op.kind) for op in jl.operations.values()]
    assert tbytes == jbytes


@pytest.mark.parametrize("name", LOWERING_GRAPHS)
def test_arg_specs_are_the_jax_package_s(name):
    jt, tt, args, storage = lowering_case(name)
    got = arg_specs_from_arguments(args, storage=storage, comp=tt)
    want = jspecs(args, storage=storage, comp=jt)
    assert list(got) == list(want)
    for key, spec in want.items():
        if isinstance(spec, tuple):
            assert got[key][0] == spec[0] and np.dtype(got[key][1]) == \
                np.dtype(spec[1]), key
        else:
            assert got[key] == spec, key


def test_lowered_graphs_hold_host_ops_only(lowered):
    """Every placement of a lowered graph is a host, and the protocol
    ops are the reference's (config 3: 7,335 host ops, one Dot a party
    and contraction)."""
    _, _, _, tl = lowered["logreg"]
    assert {type(p).__name__ for p in tl.placements.values()} == \
        {"HostPlacement"}
    kinds = [op.kind for op in tl.operations.values()]
    assert len(kinds) == 7335
    assert kinds.count("Dot") == 6
    for kind in ("PrfKeyGen", "DeriveSeed", "SampleSeeded", "Send",
                 "Receive"):
        assert kind in kinds


def test_default_passes_are_the_reference_s():
    assert DEFAULT_PASSES == JAX_DEFAULT_PASSES == [
        "typing", "lowering", "prune", "networking", "toposort"]


def test_unpinned_lowerings_differ_only_in_their_sync_keys():
    jt, tt, args, storage = lowering_case("rep_mul")
    specs = arg_specs_from_arguments(args)
    a = compile_computation(tt, DEFAULT_PASSES, specs)
    b = compile_computation(tt, DEFAULT_PASSES, specs)
    assert list(a.operations) == list(b.operations)
    differ = {op.kind for op in a.operations.values()
              if op.attributes != b.operations[op.name].attributes}
    assert differ == {"DeriveSeed"}
    with thost.deterministic_sync_keys(3):
        c = compile_computation(tt, DEFAULT_PASSES, specs)
    with thost.deterministic_sync_keys(3):
        d = compile_computation(tt, DEFAULT_PASSES, specs)
    assert tserde.serialize_computation(c) == tserde.serialize_computation(d)


def test_lowering_needs_a_spec_for_every_input():
    from moose_tpu_torch.errors import MissingArgumentError

    _, tt, _, _ = lowering_case("rep_dot")
    with pytest.raises(MissingArgumentError, match="arg_specs"):
        compile_computation(tt, DEFAULT_PASSES, {"x": ((8, 5), "float64")})


def test_secret_shared_checkpoints_are_not_lowered_yet():
    # ROADMAP queue 1, item 10 lowers them now: a host value shared and
    # saved as shares is the JAX package's host graph byte for byte, each
    # party's ring-typed Save of its own pair named as the reference
    # names it, the last keeping the logical op's name
    def save_of(pm):
        alice = pm.host_placement("alice")
        bob = pm.host_placement("bob")
        carole = pm.host_placement("carole")
        rep = pm.replicated_placement("rep", players=[alice, bob, carole])

        @pm.computation
        def save(x: pm.Argument(alice, dtype=pm.float64)):
            with alice:
                xf = pm.cast(x, dtype=pm.fixed(24, 40))
            with rep:
                out = pm.save_shares("w", xf)
            return out

        return save

    specs = {"x": ((2,), np.dtype("float64"))}
    with jhost.deterministic_sync_keys(9):
        want = jcompile(jtracer.trace(save_of(jm)), JAX_DEFAULT_PASSES,
                        specs)
    with thost.deterministic_sync_keys(9):
        got = compile_computation(ttracer.trace(save_of(tm)),
                                  DEFAULT_PASSES, specs)
    assert tserde.serialize_computation(got) == \
        jserde.serialize_computation(want)
    saves = sorted(op.name for op in got.operations.values()
                   if op.kind == "Save")
    assert len(saves) == 6 and sum("_p" not in n for n in saves) == 1


def _decrypt_graphs(kind):
    if kind == "host":
        from test_torch_aes import _host_decrypt

        graphs = (_host_decrypt(jm), _host_decrypt(tm))
        data = (224, 1, 2)
    else:
        cs = load_chip_smoke()
        graphs = tuple(cs.decrypt_computation(pm, pm.fixed(24, 40))
                       for pm in (jm, tm))
        data = (224, 2)
    specs = {"aes_data": (data, np.dtype("uint8")),
             "aes_key": ((128,), np.dtype("uint8"))}
    return graphs, specs


@pytest.mark.parametrize("kind", ("host", "replicated"))
def test_lowered_decrypt_is_the_jax_package_s_bytes(kind):
    """A host Decrypt (``HostBitOps``) and a replicated one
    (``RepBitOps``, the circuit on replicated bit shares) lower to the
    JAX package's bytes."""
    (jc, tc), specs = _decrypt_graphs(kind)
    with jhost.deterministic_sync_keys(9):
        want = jserde.serialize_computation(jcompile(
            jtracer.trace(jc), JAX_DEFAULT_PASSES, specs))
    with thost.deterministic_sync_keys(9):
        got = tserde.serialize_computation(compile_computation(
            ttracer.trace(tc), DEFAULT_PASSES, specs))
    assert got == want
