"""The keystream analysis (MSA8xx) and the draw oracles in the port, on
the CPU.

- Every test function of ``tests/test_keystream.py`` runs again with its
  analysis calls mirrored (``tests/torch_analysis_mirror.py``): the
  port's diagnostics and ``keystream_report`` on the same graph must equal
  the JAX package's exactly; the worker-plan keystream gate
  (``test_worker_plan_keystream_gate``) also holds the port's worker plan
  (its gate's diagnostics and refusal) to the JAX package's.
- The draw oracles of ``tests/test_keystream_oracle.py`` within the port:
  the static per-(party, key) draw counts of a graph equal the draw
  ledger of a per-host run, and the shape-only ``meta`` replay of the
  stacked layout equals the ledger of a stacked run, event for event.  The
  static sides equal the JAX package's static sides.  The cases the JAX
  file marks slow are slow here too.
- The kernel wrappers' ``meta`` branch: shapes only, no launch, no count;
  any device but the CPU, CUDA and ``meta`` still raises.
- Both packages' trainers lint at trace time, which lowers the graph and
  draws sync keys: under the same pinned nonces the two streams stay
  equal after a gated trace.
"""

import numpy as np
import pytest
import torch

import moose_tpu as jm
from moose_tpu.compilation.analysis import keystream as jkeystream
from moose_tpu.dialects import host as jhost
from moose_tpu.edsl import tracer as jtracer
from moose_tpu.predictors import trainers as jtrainers

import moose_tpu_torch as tm
from moose_tpu_torch.compilation.analysis.keystream import (
    host_draw_counts,
    keystream_report,
    stacked_draw_trace,
)
from moose_tpu_torch.dialects import host as thost
from moose_tpu_torch.edsl import tracer as ttracer
from moose_tpu_torch.execution import drawledger
from moose_tpu_torch.native import ring_kernels as rk
from moose_tpu_torch.predictors import trainers as ttrainers
from moose_tpu_torch.runtime import LocalMooseRuntime as PortRuntime

import test_keystream as jax_keystream
from torch_analysis_mirror import cases, mirror, mirror_worker_plan, \
    run_case
from torch_parity import fixed_keys_env

PARTIES = ["alice", "bob", "carole"]
RING64, RING128 = (8, 17), (24, 40)
N_ROWS, N_FEATURES, HIDDEN = 4, 2, 2


@pytest.mark.parametrize("name,params", cases(jax_keystream))
def test_keystream_case_matches_port(name, params, request, monkeypatch):
    mirror(monkeypatch, jax_keystream)
    mirror_worker_plan(monkeypatch)
    assert run_case(jax_keystream, name, params, request) > 0


# -- the draw oracles ------------------------------------------------------


def _predict_graph(pm, model, fx):
    """The serving graph of ``tests/test_keystream_oracle.py`` for
    either package's module: plaintext in, one replicated forward pass,
    the result revealed to the data owner."""
    alice = pm.host_placement("alice")
    bob = pm.host_placement("bob")
    carole = pm.host_placement("carole")
    rep = pm.replicated_placement("rep", players=[alice, bob, carole])
    fx = pm.fixed(*fx)
    if model == "logreg":

        @pm.computation
        def predict(x: pm.Argument(alice, dtype=pm.float64),
                    w: pm.Argument(bob, dtype=pm.float64)):
            with alice:
                xf = pm.cast(x, dtype=fx)
            with bob:
                wf = pm.cast(w, dtype=fx)
            with rep:
                y = pm.sigmoid(pm.dot(xf, wf))
            with alice:
                return pm.cast(y, dtype=pm.float64)

        return predict, {"x": (N_ROWS, N_FEATURES), "w": (N_FEATURES, 1)}

    @pm.computation
    def predict(x: pm.Argument(alice, dtype=pm.float64),
                w1: pm.Argument(bob, dtype=pm.float64),
                w2: pm.Argument(bob, dtype=pm.float64)):
        with alice:
            xf = pm.cast(x, dtype=fx)
        with bob:
            w1f = pm.cast(w1, dtype=fx)
            w2f = pm.cast(w2, dtype=fx)
        with rep:
            h = pm.sigmoid(pm.dot(xf, w1f))
            y = pm.sigmoid(pm.dot(h, w2f))
        with alice:
            return pm.cast(y, dtype=pm.float64)

    return predict, {"x": (N_ROWS, N_FEATURES), "w1": (N_FEATURES, HIDDEN),
                     "w2": (HIDDEN, 1)}


def _graphs(model, graph, fx):
    """(JAX graph, port graph, arg specs, arguments) of one oracle case,
    the arguments made from a seed with numpy."""
    rng = np.random.default_rng(20260806)
    if graph == "step":
        built = []
        for pm, trainers in ((jm, jtrainers), (tm, ttrainers)):
            if model == "logreg":
                trainer = trainers.LogregSGDTrainer(
                    n_features=N_FEATURES, fixedpoint_dtype=pm.fixed(*fx))
            else:
                trainer = trainers.MLPSGDTrainer(
                    n_features=N_FEATURES, hidden=HIDDEN,
                    fixedpoint_dtype=pm.fixed(*fx))
            built.append(trainer.step_computation(N_ROWS))
        specs = dict(trainer.range_specs(N_ROWS)[0])
        args = {"x": rng.normal(size=(N_ROWS, N_FEATURES)) * 0.3,
                "y": rng.uniform(size=(N_ROWS, 1))}
        for name, shape in trainer.state_shapes.items():
            args[name] = rng.normal(size=shape) * 0.3
        return built[0], built[1], specs, args
    (jc, specs), (tc, _) = (_predict_graph(pm, model, fx)
                            for pm in (jm, tm))
    args = {name: rng.normal(size=shape) * 0.3
            for name, shape in specs.items()}
    return jtracer.trace(jc), ttracer.trace(tc), specs, args


def _case(model, graph, fx, slow_unless):
    name = "ring64" if fx == RING64 else "ring128"
    return pytest.param(
        model, graph, fx, id=f"{model}-{graph}-{name}",
        marks=() if (model, graph, name) in slow_unless
        else pytest.mark.slow)


# the JAX file's tier-1 cases of both oracles; the rest of its matrix is
# slow there too
CASES = [
    _case(model, graph, fx, {("logreg", "step", "ring64"),
                             ("logreg", "predict", "ring128")})
    for model in ("logreg", "mlp") for graph in ("step", "predict")
    for fx in (RING64, RING128)
]


@pytest.mark.parametrize("model,graph,fx", CASES)
def test_per_host_draw_counts_match_ledger(model, graph, fx):
    jc, tc, specs, args = _graphs(model, graph, fx)
    static = host_draw_counts(tc, arg_specs=specs)
    assert static, "static report found no draws"
    assert static == jkeystream.host_draw_counts(jc, arg_specs=specs)
    runtime = PortRuntime(PARTIES, layout="per-host", use_jit=False,
                          device="cpu")
    with fixed_keys_env("keystream-oracle"), \
            drawledger.recording() as ledger:
        runtime.evaluate_computation(tc, arguments=args)
    assert static == ledger.host_report()


@pytest.mark.parametrize("model,graph,fx", CASES)
def test_stacked_draw_trace_matches_run(model, graph, fx):
    jc, tc, specs, args = _graphs(model, graph, fx)
    rk.reset_launches()
    static = stacked_draw_trace(tc, specs)
    # the meta replay computes nothing, so it launches and counts nothing
    assert not any(rk.LAUNCHES.values())
    assert static, "static trace is empty"
    assert static == jkeystream.stacked_draw_trace(jc, specs)
    runtime = PortRuntime(PARTIES, layout="stacked", device="cpu")
    with fixed_keys_env("keystream-oracle"), \
            drawledger.recording() as ledger:
        runtime.evaluate_computation(tc, arguments=args)
    assert runtime.last_plan["layout"] == "stacked"
    assert ledger.stacked_trace() == static
    assert ledger.stacked_counts()["bank"] > 0


def test_nonce_streams_agree_after_a_gated_trace():
    """Each package's trainer lints its graph at trace time, lowering it
    and drawing sync keys: under the same pinned nonces both draw the
    same keys, so the graphs lowered next are byte-equal too."""
    from moose_tpu import serde as jserde
    from moose_tpu.compilation import compile_computation as jcompile
    from moose_tpu.compilation import DEFAULT_PASSES as JPASSES

    from moose_tpu_torch import serde as tserde
    from moose_tpu_torch.compilation import (
        DEFAULT_PASSES,
        compile_computation,
    )

    specs = {"x": ((8, 3), np.dtype("float64")),
             "y": ((8, 1), np.dtype("float64"))}
    out = []
    for host_mod, trainers, compile_fn, passes, serde in (
            (jhost, jtrainers, jcompile, JPASSES, jserde),
            (thost, ttrainers, compile_computation, DEFAULT_PASSES,
             tserde)):
        with host_mod.deterministic_sync_keys(7):
            comp = trainers.LogregSGDTrainer(3, 0.1).epoch_computation(8)
            keys = [host_mod.random_sync_key() for _ in range(4)]
            lowered = serde.serialize_computation(
                compile_fn(comp, passes, specs))
        out.append((keys, lowered))
    assert out[0] == out[1]


def test_keystream_report_of_config3_matches_the_jax_package():
    """Config 3's logistic regression at 8 x 5, lowered inside both
    packages' pinned sync keys: the MSA805 report is the JAX package's."""
    from torch_parity import traced_pair

    jc, tc = traced_pair("logreg")
    specs = {"x": (8, 5)}
    with jhost.deterministic_sync_keys(3):
        want = jkeystream.keystream_report(jc, arg_specs=specs)
    with thost.deterministic_sync_keys(3):
        got = keystream_report(tc, arg_specs=specs)
    assert got == want and got["analyzed"] and got["draws"]


# -- the kernel wrappers on meta -------------------------------------------


def _meta(shape, width=128, device="meta"):
    lo = torch.empty(shape, dtype=torch.int64, device=device)
    return lo, (torch.empty(shape, dtype=torch.int64, device=device)
                if width == 128 else None)


def _wrapper_calls(device):
    """Each wrapper of ``native.ring_kernels`` at a small shape, with its
    expected output shapes."""
    x, v, w = (4, 3), (3, 4, 3), (3, 3, 2)
    width = 128
    pair = (3, 2) + x
    banks = torch.empty((rk.adder_bank_count(64), 3, 64) + x,
                        dtype=torch.uint8, device=device)
    raws = [1, 2, 3]
    return [
        ("dot_cross_terms", lambda: rk.dot_cross_terms(
            _meta(v, width, device), _meta(v, width, device),
            _meta(w, width, device), _meta(w, width, device), width),
         (3, 4, 2)),
        ("party_dot_cross_terms", lambda: rk.party_dot_cross_terms(
            _meta((4, 3), width, device), _meta((4, 3), width, device),
            _meta((3, 2), width, device), _meta((3, 2), width, device),
            width), (4, 2)),
        ("ring_matmul", lambda: rk.ring_matmul(
            _meta((4, 3), width, device), _meta((3, 2), width, device),
            width), (4, 2)),
        ("trunc_combine", lambda: rk.trunc_combine(
            _meta(x, width, device), _meta(x, width, device),
            [_meta(x, width, device)] * 5, width, 20), (3,) + x),
        ("trunc_pairs", lambda: rk.trunc_pairs(
            _meta(pair, width, device), _meta((5,) + x, width, device),
            width, 20), pair),
        ("cross_terms_mul", lambda: rk.cross_terms_mul(
            *[_meta(x, width, device)] * 4, width), x),
        ("cross_terms_reshare", lambda: rk.cross_terms_reshare(
            _meta(pair, width, device), _meta(pair, width, device),
            _meta((3,) + x, width, device), width), pair),
        ("ring_mul", lambda: rk.ring_mul(
            *_meta(x, width, device), *_meta((3,), width, device), width),
         x),
        ("bit_decompose", lambda: rk.bit_decompose(
            *_meta(pair, 64, device), 64, banks), (3, 2, 64) + x),
        ("msb", lambda: rk.msb(*_meta(pair, 64, device), 64, banks), pair),
        ("horner_pairs", lambda: rk.horner_pairs(
            _meta(pair, width, device), width, raws, 20,
            _meta((2, 3) + x, width, device),
            _meta((2, 5) + x, width, device)), pair),
        ("horner", lambda: rk.horner(
            _meta((3,) + x, width, device), _meta((3,) + x, width, device),
            width, raws, 20, _meta((2, 3) + x, width, device),
            _meta((2, 5) + x, width, device)), (3,) + x),
        ("threefry_group", lambda: rk.threefry_group(
            (1, 2, 3, 4), 0, 5, "threefry", [rk.GroupDraw(False, 8, (
                (torch.empty(16, dtype=torch.int64, device=device), 0),
                (torch.empty(16, dtype=torch.int64, device=device), 8)))]),
         None),
        ("threefry_words", lambda: rk.threefry_words(
            1, 2, 12, "threefry", device), (12,)),
        ("threefry_bits", lambda: rk.threefry_bits(
            1, 2, 12, "threefry-pallas", device), (12,)),
    ]


WRAPPERS = 15
# the draws under a given key: the per-host layout's single draws, which
# no stacked walk reaches, take the CPU or CUDA only
# (tests/test_torch_prf.py holds their refusal of meta)
GIVEN_KEY = ("threefry_words", "threefry_bits")


@pytest.mark.parametrize("index", range(WRAPPERS - len(GIVEN_KEY)))
def test_meta_branch_of_each_wrapper_launches_nothing(index):
    calls = [c for c in _wrapper_calls("meta") if c[0] not in GIVEN_KEY]
    assert len(calls) == WRAPPERS - len(GIVEN_KEY)
    name, call, shape = calls[index]
    rk.reset_launches()
    out = call()
    assert not any(rk.LAUNCHES.values()), name
    if shape is None:  # a group fill returns nothing
        assert out is None, name
        return
    first = out
    while isinstance(first, tuple):  # (lo, hi) words, or horner's slots
        first = first[0]
    assert first.device.type == "meta", name
    assert tuple(first.shape) == shape, name


def test_meta_group_fill_is_a_no_op():
    buf = torch.empty(64, dtype=torch.int64, device="meta")
    bits = torch.empty(64, dtype=torch.uint8, device="meta")
    draws = [rk.GroupDraw(False, 8, ((buf, 0), (buf, 8))),
             rk.GroupDraw(True, 16, ((bits, 0),))]
    rk.reset_launches()
    for layout in ("threefry", "threefry-pallas"):
        rk.threefry_group((1, 2, 3, 4), 0, 5, layout, draws)
    rk.aes_ctr_group((1, 2, 3, 4), 0, 5, draws)
    assert not any(rk.LAUNCHES.values())
    assert rk.AES_CTR_HOST == {"bytes": 0, "ms": 0.0}


class _Elsewhere(torch.Tensor):
    """A CPU tensor that reports another device, as a tensor of a
    device the wrappers do not take would."""

    @property
    def device(self):
        return torch.device("xpu")


@pytest.mark.parametrize("index", range(WRAPPERS))
def test_other_devices_still_raise(index, monkeypatch):
    real_empty = torch.empty

    def elsewhere(*args, device=None, **kwargs):
        return real_empty(*args, **kwargs).as_subclass(_Elsewhere)

    monkeypatch.setattr(torch, "empty", elsewhere)
    calls = _wrapper_calls("xpu")
    assert len(calls) == WRAPPERS
    name, call, _ = calls[index]
    rk.reset_launches()
    with pytest.raises(ValueError, match="CPU or CUDA|CUDA tensors"):
        call()
    assert not any(rk.LAUNCHES.values()), name
