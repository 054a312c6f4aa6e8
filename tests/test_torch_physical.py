"""The port's physical executor against the JAX package's, on the small
lowering graphs: the five graphs of tests/test_compiler.py's lowering
tests, a small convolution and a host Select, each lowered by both
packages under one pinned nonce stream (tests/torch_parity.py
``lowered_pair``) and run by ``execute_physical`` (the JAX one at
``use_jit=False``) under fixed keys, where PrfKeyGen keys derive from
the op names.  Outputs and storage must be word-equal; the one float
host Exp (``host_math``) may differ by one ulp, libm against XLA's.
``LocalMooseRuntime.evaluate_compiled`` of a lowered blob the JAX package
wrote gives its words too.  Config 3 and the softmax head run in
tests/test_torch_physical_models.py."""

import copy

import numpy as np
import pytest

import moose_tpu  # noqa: F401  (jax x64 before any jnp use)
from moose_tpu import serde as jserde
from moose_tpu.execution.physical import execute_physical as jexecute

from moose_tpu_torch.execution.physical import (
    PhysicalInterpreter,
    execute_physical,
)
from moose_tpu_torch.native import ring_kernels as rk
from moose_tpu_torch.runtime import LocalMooseRuntime as PortRuntime

from torch_parity import fixed_keys_env, lowered_pair, prf

IDS = ["alice", "bob", "carole"]
GRAPHS = ("host_math", "rep_dot", "rep_sigmoid", "save_load", "rep_mul",
          "structural", "select")


def assert_outputs_equal(got, want, ulp_names=()):
    assert list(got) == list(want)
    for name in want:
        g, w = np.asarray(got[name]), np.asarray(want[name])
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if name in ulp_names:
            np.testing.assert_array_max_ulp(g, w, maxulp=1)
        else:
            assert np.array_equal(g, w), name


def run_both(name):
    """(port outputs, port storage, JAX outputs, JAX storage, JAX lowered
    graph, arguments) of one graph through both physical executors."""
    jl, tl, args, storage = lowered_pair(name)
    jstore, tstore = copy.deepcopy(storage), copy.deepcopy(storage)
    with prf("threefry"), fixed_keys_env():
        want = jexecute(jl, jstore, args, use_jit=False)
        got = execute_physical(tl, tstore, args, device="cpu")
    return got, tstore, want, jstore, jl, args


@pytest.fixture(scope="module")
def runs():
    rk.reset_launches()
    out = {name: run_both(name) for name in GRAPHS}
    out["launches"] = dict(rk.LAUNCHES)
    return out


@pytest.mark.parametrize("name", GRAPHS)
def test_physical_executor_gives_the_jax_package_s_words(runs, name):
    got, _, want, _, _, _ = runs[name]
    assert_outputs_equal(got, want,
                         ("output_0",) if name == "host_math" else ())


def test_physical_executor_writes_the_jax_package_s_storage(runs):
    _, tstore, _, jstore, _, _ = runs["save_load"]
    assert tstore.keys() == jstore.keys()
    for plc, store in jstore.items():
        assert tstore[plc].keys() == store.keys()
        for key, value in store.items():
            got = tstore[plc][key]
            assert isinstance(got, np.ndarray)
            assert np.array_equal(got, np.asarray(value)), key
    assert np.array_equal(tstore["alice"]["squared"], [4.0, 9.0])


def test_the_cpu_counts_no_launch(runs):
    assert not any(runs["launches"].values())


def test_evaluate_compiled_runs_a_jax_written_lowered_blob(runs):
    _, _, want, _, jl, args = runs["rep_dot"]
    blob = jserde.serialize_computation(jl)
    runtime = PortRuntime(IDS, device="cpu")
    with prf("threefry"), fixed_keys_env():
        got = runtime.evaluate_compiled(blob, args)
        again = runtime.evaluate_compiled(blob, args)
    assert_outputs_equal(got, want)
    assert_outputs_equal(again, want)
    assert runtime.last_plan == {"layout": "per-host", "lowered": True,
                                 "plan_mode": "eager", "pinned_ops": []}
    assert np.abs(got["output_0"] - args["x"] @ args["w"]).max() < 1e-5


def test_fresh_keys_vary_and_stay_within_the_tolerance(runs):
    """Without fixed keys each evaluation draws its own PRF keys: the
    words differ from run to run, the decoded product does not."""
    _, tl = lowered_pair("rep_dot")[:2]
    _, _, _, _, _, args = runs["rep_dot"]
    with prf("threefry"):
        a = execute_physical(tl, {}, args, device="cpu")["output_0"]
        b = execute_physical(tl, {}, args, device="cpu")["output_0"]
    want = args["x"] @ args["w"]
    assert np.abs(a - want).max() < 1e-5 and np.abs(b - want).max() < 1e-5


def test_distributed_mode_names_item_12(runs):
    """A worker's role runs in the distributed worker, which the
    physical executor names."""
    _, tl = lowered_pair("rep_mul")[:2]
    with pytest.raises(NotImplementedError, match="execute_role"):
        execute_physical(tl, {}, {}, identity="alice", device="cpu")
    with pytest.raises(NotImplementedError, match="execute_role"):
        PhysicalInterpreter("cpu").evaluate(tl, {}, {}, identity="bob")


def test_entry_point_defaults_to_the_card():
    import torch

    from moose_tpu_torch.errors import ConfigurationError

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _, tl = lowered_pair("host_math")[:2]
    with pytest.raises(ConfigurationError, match="device='cpu'"):
        execute_physical(tl, {}, {"x": np.zeros(3)})
