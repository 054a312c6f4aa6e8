"""The lowered route at the model level: config 3's logistic regression
(8 x 5) and a softmax head lowered by both packages and run by their
physical executors under fixed keys give equal words; the port's
``LocalMooseRuntime`` routes a graph as the JAX runtime does (stacked,
the per-host walk, or lowered to the physical executor, by ``layout``,
``use_jit`` and ``_auto_lower_passes``), and at ``use_jit=True`` its
per-host config-3 request is the JAX package's ``execute_physical`` of
the same lowered graph, word for word (the JAX package's jit and eager
plans are word-equal there; its eager one runs here, about 15-20 s of
first-use compiles for each model on the CPU)."""

import numpy as np
import pytest

import moose_tpu  # noqa: F401  (jax x64 before any jnp use)
from moose_tpu.execution.physical import execute_physical as jexecute
from moose_tpu.runtime import LocalMooseRuntime as JaxRuntime

from moose_tpu_torch.compilation import DEFAULT_PASSES
from moose_tpu_torch.dialects import host as thost
from moose_tpu_torch.execution.physical import execute_physical
from moose_tpu_torch.runtime import LocalMooseRuntime as PortRuntime

from torch_parity import (
    LOWERING_GRAPHS,
    fixed_keys_env,
    lowered_pair,
    lowering_case,
    prf,
    traced_pair,
)

IDS = ["alice", "bob", "carole"]
MODELS = ("logreg", "multinomial")
SEED = 20261017  # lowered_pair's nonce seed


@pytest.fixture(scope="module")
def runs():
    """Each model lowered by both packages and run by both physical
    executors under fixed keys."""
    out = {}
    with prf("threefry"), fixed_keys_env():
        for name in MODELS:
            jl, tl, args, _ = lowered_pair(name, SEED)
            out[name] = (execute_physical(tl, {}, args, device="cpu"),
                         jexecute(jl, {}, args, use_jit=False), args)
    return out


@pytest.mark.parametrize("name", MODELS)
def test_physical_executor_gives_the_jax_package_s_words(runs, name):
    got, want, args = runs[name]
    assert list(got) == list(want)
    g, w = got["output_0"], np.asarray(want["output_0"])
    assert g.dtype == w.dtype and g.shape == w.shape
    assert np.array_equal(g, w)
    assert g.shape == (8, 2 if name == "logreg" else 3)
    assert np.abs(g.sum(axis=1) - 1.0).max() < 1e-6


def test_use_jit_routes_config_3_to_the_physical_executor(runs):
    """At use_jit=True a per-host config-3 request is lowered (its
    Sigmoid weighs 4,600 lowered host ops, past the segment limit of
    2,000) and runs on the physical executor: with the lowering's nonces
    pinned, the JAX package's words.  The lowered graph is cached: a
    second request lowers nothing, and gives the same words."""
    _, want, args = runs["logreg"]
    _, tt, _, _ = lowering_case("logreg")
    runtime = PortRuntime(IDS, layout="per-host", use_jit=True,
                          device="cpu")
    with prf("threefry"), fixed_keys_env():
        with thost.deterministic_sync_keys(SEED):
            got = runtime.evaluate_computation(tt, args)
        assert runtime.last_plan == {"layout": "per-host", "lowered": True,
                                     "plan_mode": "eager", "pinned_ops": []}
        again = runtime.evaluate_computation(tt, args)
    assert np.array_equal(got["output_0"], np.asarray(want["output_0"]))
    assert np.array_equal(again["output_0"], got["output_0"])
    assert len(runtime._compiled_cache[tt]) == 1


def test_use_jit_false_keeps_the_logical_walk():
    _, tt, args, _ = lowering_case("logreg")
    runtime = PortRuntime(IDS, layout="per-host", use_jit=False,
                          device="cpu")
    with prf("threefry"):
        out = runtime.evaluate_computation(tt, args)["output_0"]
    assert runtime.last_plan["lowered"] is False
    assert out.shape == (8, 2)


def _aes_input_trace():
    return traced_pair("aes_input")


@pytest.mark.parametrize("name", LOWERING_GRAPHS + ("secure_dot",
                                                    "aes_input"))
def test_auto_lowering_decides_as_the_jax_runtime(name):
    if name in LOWERING_GRAPHS:
        jt, tt, _, _ = lowering_case(name)
    else:
        jt, tt = traced_pair(name)
    want = JaxRuntime(IDS, use_jit=False)._auto_lower_passes(jt)
    got = PortRuntime._auto_lower_passes(tt)
    assert got == want
    if name in ("rep_sigmoid", "logreg", "multinomial"):
        assert got == DEFAULT_PASSES
    if name == "aes_input":
        assert got is None


@pytest.mark.parametrize("env", (None, "0", "1", "yes"))
def test_use_jit_resolves_as_the_jax_runtime(monkeypatch, env):
    if env is None:
        monkeypatch.delenv("MOOSE_TPU_JIT", raising=False)
    else:
        monkeypatch.setenv("MOOSE_TPU_JIT", env)
    assert PortRuntime(IDS, device="cpu").use_jit is \
        JaxRuntime(IDS).use_jit
    assert PortRuntime(IDS, use_jit=False, device="cpu").use_jit is False


@pytest.mark.parametrize("layout,use_jit,name,route", (
    ("auto", True, "secure_dot", ("stacked", False)),
    ("per-host", True, "secure_dot", ("per-host", False)),
    ("per-host", True, "rep_sigmoid", ("per-host", True)),
    ("per-host", False, "rep_sigmoid", ("per-host", False)),
    ("auto", True, "host_math", ("per-host", False)),
    ("stacked", False, "rep_mul", ("stacked", False)),
))
def test_runtime_routes_as_the_jax_runtime(layout, use_jit, name, route):
    """The route (layout, lowered) of the JAX runtime's
    ``_evaluate_computation``: the stacked layout where it runs the
    graph, else lowering where ``_auto_lower_passes`` asks for it under
    use_jit, else the walk."""
    if name == "secure_dot":
        _, tt = traced_pair(name)
        args = {"x": np.ones((2, 3)), "y": np.ones((3, 2))}
    else:
        _, tt, args, _ = lowering_case(name)
    runtime = PortRuntime(IDS, layout=layout, use_jit=use_jit,
                          device="cpu")
    with prf("threefry"):
        runtime.evaluate_computation(tt, args)
    assert (runtime.last_plan["layout"],
            runtime.last_plan["lowered"]) == route


def test_compiler_passes_always_lower():
    _, tt, args, _ = lowering_case("rep_mul")
    runtime = PortRuntime(IDS, use_jit=False, device="cpu")
    with prf("threefry"):
        out = runtime.evaluate_computation(tt, args,
                                           compiler_passes=DEFAULT_PASSES)
    assert runtime.last_plan["lowered"] is True
    assert np.abs(out["output_0"] - args["x"] * args["y"]).max() < 1e-6
