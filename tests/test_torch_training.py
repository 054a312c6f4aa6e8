"""The SGD trainers' secure training step through the JAX LocalMooseRuntime
(stacked layout) and the port's, on the CPU: bit-identical weights under
fixed keys, within 1e-4 of ``reference_epoch`` per step; plus the
replicated transpose word for word and the step graph's op kinds.

Each JAX result is computed once per module and shared by the cases
that read it: the JAX step costs tens of seconds cold on the CPU (its
``threefry-pallas`` draws run the Pallas kernel in interpret mode)."""

import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

import moose_tpu as jm
from moose_tpu.dialects import stacked as jstacked
from moose_tpu.parallel import spmd as jspmd
from moose_tpu.predictors import trainers as jtrainers
from moose_tpu.runtime import LocalMooseRuntime as JaxRuntime

import moose_tpu_torch as tm
from moose_tpu_torch.dialects import stacked as tstacked
from moose_tpu_torch.native import ring_kernels as rk
from moose_tpu_torch.parallel import spmd as tspmd
from moose_tpu_torch.predictors import trainers as ttrainers
from moose_tpu_torch.runtime import LocalMooseRuntime as PortRuntime

from torch_parity import (
    assert_words_equal,
    fixed_keys_env,
    prf,
    rand_words,
    to_jax,
    to_port,
)

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

IDS = ["alice", "bob", "carole"]
ROWS, FEATURES, HIDDEN = 16, 6, 4
PRECISION = (24, 40)


def _trainers(kind):
    """The same trainer in both packages."""
    if kind == "logreg":
        return (
            jtrainers.LogregSGDTrainer(
                FEATURES, 0.1, fixedpoint_dtype=jm.fixed(*PRECISION)),
            ttrainers.LogregSGDTrainer(
                FEATURES, 0.1, fixedpoint_dtype=tm.fixed(*PRECISION)),
        )
    return (
        jtrainers.MLPSGDTrainer(
            FEATURES, HIDDEN, 0.1, fixedpoint_dtype=jm.fixed(*PRECISION)),
        ttrainers.MLPSGDTrainer(
            FEATURES, HIDDEN, 0.1, fixedpoint_dtype=tm.fixed(*PRECISION)),
    )


def _batches(seed, steps):
    x, y = chip_smoke.training_data(
        np.random.default_rng(seed), ROWS * steps, FEATURES
    )
    return [
        (x[i * ROWS:(i + 1) * ROWS], y[i * ROWS:(i + 1) * ROWS])
        for i in range(steps)
    ]


def _run_both(kind, impl, state, steps, seed):
    """``steps`` chained steps through both runtimes under fixed keys and
    the PRF ``impl``: (JAX states, port states, port errors against
    reference_epoch), one state per step."""
    jtrainer, ttrainer = _trainers(kind)
    batches = _batches(seed, steps)
    with prf(impl), fixed_keys_env():
        jrt = JaxRuntime(IDS, layout="stacked", use_jit=False)
        jstates, jstate = [], state
        for x, y in batches:
            out = jrt.evaluate_computation(
                jtrainer.step_computation(ROWS), dict(jstate, x=x, y=y)
            )
            jstate = jtrainer.unpack_export(out)
            jstates.append(jstate)
        before = dict(rk.LAUNCHES)
        tstates, errs = [], []
        tstate = state
        for batch in batches:
            tstate, err, _ = chip_smoke.train_steps(
                PortRuntime(IDS, device="cpu"), ttrainer, [batch], tstate
            )
            tstates.append(tstate)
            errs += err
        # the CPU runs the kernels' plain versions
        assert rk.LAUNCHES == before
    return jstates, tstates, errs


@pytest.fixture(scope="module")
def logreg_pallas():
    return _run_both(
        "logreg", "threefry-pallas", {"w": np.zeros((FEATURES, 1))}, 2, 7
    )


@pytest.mark.parametrize("step", (0, 1))
def test_logreg_steps_bit_identical_under_threefry_pallas(logreg_pallas,
                                                          step):
    jstates, tstates, errs = logreg_pallas
    got, want = tstates[step]["w"], jstates[step]["w"]
    assert got.shape == (FEATURES, 1) and got.dtype == np.float64
    assert np.array_equal(got, want)
    assert errs[step] < chip_smoke.TRAIN_STEP_TOL


def test_logreg_trajectory_matches_float64(logreg_pallas):
    _, tstates, _ = logreg_pallas
    trainer = _trainers("logreg")[1]
    state = {"w": np.zeros((FEATURES, 1))}
    for x, y in _batches(7, 2):
        state = trainer.reference_epoch(state, x, y)
    err = np.abs(tstates[-1]["w"] - state["w"]).max()
    assert err < chip_smoke.TRAIN_TRAJECTORY_TOL


def test_logreg_step_bit_identical_under_threefry():
    w = np.random.default_rng(3).normal(size=(FEATURES, 1)) * 0.5
    jstates, tstates, errs = _run_both("logreg", "threefry", {"w": w}, 1, 8)
    assert np.array_equal(tstates[0]["w"], jstates[0]["w"])
    assert errs[0] < chip_smoke.TRAIN_STEP_TOL


def test_mlp_step_bit_identical_under_threefry_pallas():
    rng = np.random.default_rng(4)
    state = {"w1": rng.normal(size=(FEATURES, HIDDEN)) * 0.5,
             "w2": rng.normal(size=(HIDDEN, 1)) * 0.5}
    jstates, tstates, errs = _run_both(
        "mlp", "threefry-pallas", state, 1, 9
    )
    for name, shape in (("w1", (FEATURES, HIDDEN)), ("w2", (HIDDEN, 1))):
        assert tstates[0][name].shape == shape
        assert np.array_equal(tstates[0][name], jstates[0][name])
    assert errs[0] < chip_smoke.TRAIN_STEP_TOL


def _kinds(comp):
    return [
        (type(comp.placement_of(comp.operations[name])).__name__,
         comp.operations[name].kind)
        for name in comp.toposort_names()
    ]


@pytest.mark.parametrize("kind", ("logreg", "mlp"))
def test_step_graph_traces_the_jax_op_kinds(kind):
    jtrainer, ttrainer = _trainers(kind)
    want = _kinds(jtrainer.step_computation(ROWS))
    comp = ttrainer.step_computation(ROWS)
    assert _kinds(comp) == want
    assert ("ReplicatedPlacement", "Transpose") in want
    assert tstacked.supports(comp)
    # memoized: one traced graph per (dtype, rows)
    assert ttrainer.step_computation(ROWS) is comp


def _diagnostics(error):
    return [(d.rule, int(d.severity), d.op, d.placement, d.message)
            for d in error.diagnostics]


def test_checkpointed_epochs_name_their_roadmap_items():
    # ROADMAP queue 1, item 10 ported the checkpointed epochs: each graph
    # traces the JAX package's op kinds (its bytes:
    # tests/test_torch_training_session.py), and each passes the
    # build-time range and keystream lint (item 13a) at its trace, as the
    # JAX graphs do
    jtrainer, trainer = _trainers("logreg")
    for name, args in (("init", ()), ("export", ()), ("epoch", (ROWS,))):
        comp = getattr(trainer, f"{name}_computation")(*args)
        assert _kinds(comp) == _kinds(
            getattr(jtrainer, f"{name}_computation")(*args))
    assert ("ReplicatedPlacement", "SaveShares") in _kinds(
        trainer.epoch_computation(ROWS))
    comp = trainer.epoch_computation(ROWS)
    assert trainer._range_lint(comp, ROWS) is comp


@pytest.mark.parametrize("precision,bound", (
    ((24, 40), 1e9),  # 69.9 raw bits against the ring128 budget of 64
    ((8, 27), 1e4),  # 40.3 raw bits against the ring64 budget of 35
), ids=("fixed24_40-1e9", "fixed8_27-1e4"))
def test_range_gate_refuses_an_overflowing_trainer_as_the_reference(
        precision, bound):
    """The trainers lint every graph at its trace: declared feature and
    weight ranges that overflow the ring raise MSA701 at build time, in
    the port as in the JAX package, with equal diagnostics."""
    from moose_tpu.errors import MalformedComputationError as JaxMalformed

    from moose_tpu_torch.errors import MalformedComputationError

    errors = []
    for pkg, trainers, malformed in ((jm, jtrainers, JaxMalformed),
                                     (tm, ttrainers,
                                      MalformedComputationError)):
        trainer = trainers.LogregSGDTrainer(
            5, 0.1, fixedpoint_dtype=pkg.fixed(*precision),
            feature_range=(-bound, bound), weight_range=(-bound, bound))
        with pytest.raises(malformed) as info:
            trainer.epoch_computation(16)
        errors.append(_diagnostics(info.value))
    want, got = errors
    assert got == want
    assert {rule for rule, *_ in got} == {"MSA701"}
    assert "guaranteed ring overflow" in got[0][-1]


@pytest.mark.parametrize("width", (64, 128))
@pytest.mark.parametrize("axes", (None, (1, 0, 2), (2, 0, 1)), ids=str)
def test_spmd_transpose_matches_jax(width, axes):
    rng = np.random.default_rng(width)
    words = rand_words(rng, (3, 2, 4, 5, 6), width)
    got = tspmd.transpose(tspmd.SpmdRep(*to_port(words), width), axes)
    want = jstacked._transpose(jspmd.SpmdRep(*to_jax(words), width), axes)
    assert_words_equal((got.lo, got.hi), (want.lo, want.hi))


@pytest.mark.parametrize("width", (64, 128))
def test_fx_transpose_matches_jax(width):
    words = rand_words(np.random.default_rng(width + 1), (3, 2, 5, 3), width)
    got = tspmd.fx_transpose(
        tspmd.SpmdFixed(tspmd.SpmdRep(*to_port(words), width), 24, 40)
    )
    want = jspmd.fx_transpose(
        jspmd.SpmdFixed(jspmd.SpmdRep(*to_jax(words), width), 24, 40)
    )
    assert (got.integral_precision, got.fractional_precision) == (24, 40)
    assert_words_equal((got.tensor.lo, got.tensor.hi),
                       (want.tensor.lo, want.tensor.hi))


def test_chip_smoke_training_phase_at_small_size(monkeypatch):
    # chip_smoke.py's phase 7, cut to 16 x 6 and two steps, on the CPU
    for name, value in (("TRAIN_FEATURES", FEATURES), ("TRAIN_ROWS", ROWS),
                        ("TRAIN_STEPS", 2), ("MLP_HIDDEN", HIDDEN)):
        monkeypatch.setattr(chip_smoke, name, value)
    cpu_torch = SimpleNamespace(cuda=SimpleNamespace(synchronize=lambda: None))
    with prf("threefry-pallas"):
        record = chip_smoke.run_training(
            cpu_torch, rk, PortRuntime(IDS, device="cpu"),
            np.random.default_rng(5),
        )
    assert len(record["logreg_step_ms"]) == 2
    assert len(record["mlp_step_ms"]) == chip_smoke.MLP_STEPS
    assert record["logreg_trajectory_max_abs_err"] < 1e-3
    assert not any(record["launches"].values())
