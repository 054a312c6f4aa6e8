"""The trainers' epoch graphs on the lowered route, against the JAX
package's, on the CPU.

Lowered with ``DEFAULT_PASSES`` under the same pinned sync-key nonces, an
epoch graph (``load_shares`` -> SGD steps -> ``save_shares``) is the JAX
package's host-level graph byte for byte: each party's ring-typed Load
and Save of its own ``#s0``/``#s1`` pair, named as the reference names
them.  Run on the physical executor under ``threefry`` and fixed keys,
its Saves write the JAX ``execute_physical``'s limb planes word for
word, and the runtime's own route (``use_jit=True``: an epoch's
estimated size passes the segment limit) commits the same words.  Then
``chip_smoke.py``'s phase 20 at a small size on the CPU.

The JAX package's trace of a trainer graph lowers it for its lint, which
draws sync keys: graphs are traced before the nonces are pinned.  JAX's
eager physical executor takes ~15 s for the 8 x 3 epoch of two steps
(15,000 host ops), once, in a module fixture."""

import copy
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from moose_tpu import serde as jserde
from moose_tpu.compilation import DEFAULT_PASSES as JAX_PASSES
from moose_tpu.compilation import compile_computation as jcompile
from moose_tpu.dialects import host as jhost
from moose_tpu.execution.physical import execute_physical as jexecute
from moose_tpu.predictors import trainers as jtrainers

import moose_tpu_torch as tm
from moose_tpu_torch import serde as tserde
from moose_tpu_torch.compilation import DEFAULT_PASSES, compile_computation
from moose_tpu_torch.dialects import host as thost
from moose_tpu_torch.dialects import ring
from moose_tpu_torch.execution.physical import execute_physical
from moose_tpu_torch.native import ring_kernels as rk
from moose_tpu_torch.predictors import trainers as ttrainers
from moose_tpu_torch.runtime import LocalMooseRuntime as PortRuntime
from moose_tpu_torch.storage import FilesystemStorage
from moose_tpu_torch.training import CheckpointStore

from torch_parity import fixed_keys_env, prf

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

PARTIES = ["alice", "bob", "carole"]
ROWS, FEATURES, HIDDEN = 8, 3, 4
SEED = 1234
SPECS = {"x": ((ROWS, FEATURES), np.dtype("float64")),
         "y": ((ROWS, 1), np.dtype("float64"))}


def _data():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(ROWS, FEATURES)) * 0.5
    y = (rng.uniform(size=(ROWS, 1)) > 0.5).astype(np.float64)
    return x, y


def _trainers(kind, steps):
    if kind == "logreg":
        return (jtrainers.LogregSGDTrainer(FEATURES, 0.1,
                                           steps_per_epoch=steps),
                ttrainers.LogregSGDTrainer(FEATURES, 0.1,
                                           steps_per_epoch=steps))
    return (jtrainers.MLPSGDTrainer(FEATURES, HIDDEN, 0.1,
                                    steps_per_epoch=steps),
            ttrainers.MLPSGDTrainer(FEATURES, HIDDEN, 0.1,
                                    steps_per_epoch=steps))


def _lower_both(kind, steps):
    jtrainer, ttrainer = _trainers(kind, steps)
    # traced first: the JAX trace draws sync keys for its lint
    jcomp = jtrainer.epoch_computation(ROWS)
    tcomp = ttrainer.epoch_computation(ROWS)
    with jhost.deterministic_sync_keys(SEED):
        jlowered = jcompile(jcomp, JAX_PASSES, SPECS)
    with thost.deterministic_sync_keys(SEED):
        tlowered = compile_computation(tcomp, DEFAULT_PASSES, SPECS)
    return ttrainer, jlowered, tlowered


@pytest.fixture(scope="module")
def lowered_epoch():
    """The logistic-regression epoch of two steps lowered in both
    packages, an epoch-0 state from the port's init graph, and the limb
    planes each package's physical executor saves from it."""
    ttrainer, jlowered, tlowered = _lower_both("logreg", 2)
    x, y = _data()
    with prf("threefry"), fixed_keys_env():
        init = PortRuntime(PARTIES, use_jit=False, device="cpu")
        init.evaluate_computation(
            ttrainer.init_computation(),
            {"w": np.random.default_rng(2).normal(size=(FEATURES, 1)) * 0.1})
        state = {p: dict(init.storage[p]) for p in PARTIES}
        jstore, tstore = copy.deepcopy(state), copy.deepcopy(state)
        jexecute(jlowered, jstore, {"x": x, "y": y}, use_jit=False)
        execute_physical(tlowered, tstore, {"x": x, "y": y}, device="cpu")
    return types.SimpleNamespace(
        trainer=ttrainer, jlowered=jlowered, tlowered=tlowered, state=state,
        jstore=jstore, tstore=tstore)


@pytest.mark.parametrize("kind,steps", (("logreg", 1), ("logreg", 2),
                                        ("mlp", 1)))
def test_lowered_epoch_graphs_are_the_jax_package_s_bytes(kind, steps):
    _, jlowered, tlowered = _lower_both(kind, steps)
    assert tserde.serialize_computation(tlowered) == \
        jserde.serialize_computation(jlowered)


def test_the_share_boundary_lowers_as_the_reference_names_it(lowered_epoch):
    comp = lowered_epoch.tlowered
    saves = [op for op in comp.operations.values() if op.kind == "Save"]
    loads = [op for op in comp.operations.values() if op.kind == "Load"]
    assert len(saves) == len(loads) == 6
    owners = {op.placement_name for op in saves}
    assert owners == set(PARTIES)
    for op in loads:
        assert op.signature.return_type.name == "HostRing128Tensor"
        assert op.name.rsplit("_", 1)[1] in {
            f"p{i}s{slot}" for i in range(3) for slot in (0, 1)}
    # the last Save keeps the logical SaveShares op's name
    named = [op for op in saves if "_p" not in op.name]
    assert len(named) == 1 and named[0].placement_name == "carole"
    keys = sorted(comp.operations[op.inputs[0]].attributes["value"]
                  for op in saves)
    assert keys == sorted(lowered_epoch.trainer.expected_staged() * 3)


def test_lowered_epoch_words_equal_the_jax_physical_executor_s(
        lowered_epoch):
    staged = lowered_epoch.trainer.expected_staged()
    for p in PARTIES:
        for key in staged:
            want = np.asarray(lowered_epoch.jstore[p][key])
            got = lowered_epoch.tstore[p][key]
            assert got.dtype == np.uint64 and got.shape == (2, FEATURES, 1)
            assert np.array_equal(got, want), (p, key)
            # and the epoch moved the state
            assert not np.array_equal(got, lowered_epoch.state[p][key])


def test_the_runtime_s_lowered_route_commits_the_same_words(
        lowered_epoch, tmp_path, threefry_env):
    trainer = lowered_epoch.trainer
    stores = {p: CheckpointStore(FilesystemStorage(str(tmp_path / p)),
                                 party=p) for p in PARTIES}
    for p, store in stores.items():
        for key, value in lowered_epoch.state[p].items():
            store[key] = value
        store.commit(0)
    runtime = PortRuntime(PARTIES, storage_mapping=stores, use_jit=True,
                          device="cpu")
    x, y = _data()
    with thost.deterministic_sync_keys(SEED):
        runtime.evaluate_computation(trainer.epoch_computation(ROWS),
                                     {"x": x, "y": y})
    assert runtime.last_plan == {"layout": "per-host", "lowered": True,
                                 "plan_mode": "eager", "pinned_ops": []}
    for p, store in stores.items():
        assert store.query()["staged"] == trainer.expected_staged()
        store.commit(1)
        for key in trainer.expected_staged():
            assert np.array_equal(np.asarray(store.load(key)),
                                  lowered_epoch.tstore[p][key]), (p, key)


@pytest.fixture
def threefry_env():
    with prf("threefry"), fixed_keys_env():
        yield


class _CpuTorch:
    """torch with the card's synchronize as a no-op, for chip_smoke's
    helpers on the CPU."""

    cuda = types.SimpleNamespace(synchronize=lambda: None)

    def __getattr__(self, name):
        return getattr(torch, name)


def test_chip_smoke_training_sessions_phase_at_small_size(monkeypatch):
    # chip_smoke.py's phase 20, cut to 6 features, batches of 16 and two
    # steps an epoch, on the CPU (no profiled epoch; (c) compares the
    # CPU with itself)
    for name, value in (("SESSION_FEATURES", 6), ("SESSION_BATCH", 16),
                        ("SESSION_STEPS", 2), ("TRAINED_ROWS", 8)):
        monkeypatch.setattr(chip_smoke, name, value)
    with prf("threefry"):
        record, launches = chip_smoke.run_training_sessions(
            _CpuTorch(), rk, ring, tm, PortRuntime, device="cpu")
    assert record["session"]["epochs"] == [0, 1, 2]
    assert record["session"]["max_abs_err"] < chip_smoke.SESSION_TOL
    assert len(record["session"]["commit_fanout_ms"]) == 3
    assert record["resume"]["resumes"] == 1
    assert record["resume"]["fresh_driver_skipped"] == [1, 2]
    assert record["lowered"]["epoch_lowered"] == [True, True]
    assert record["lowered"]["words_equal_to_cpu"]
    assert record["logreg_train_step"]["trajectory_max_abs_err"] < 1e-3
    assert record["trained_predictor"]["layout"] == "stacked"
    assert set(launches) == {"training_session", "training_resume",
                             "training_lowered", "logreg_train_step",
                             "trained_predictor"}
    # on the CPU no kernel launches
    assert not any(v for counts in launches.values()
                   for v in counts.values())


def test_chip_smoke_plaintext_sgd_is_the_benchmark_s():
    sys.path.insert(0, str(REPO / "benchmarks"))
    import logreg as bench

    rng = np.random.default_rng(7)
    x, y = chip_smoke.training_data(rng, 4 * 16, bench.N_FEATURES)
    assert np.array_equal(chip_smoke.plaintext_sgd(x, y, 16, 4, 0.1),
                          bench._plaintext_sgd(x, y, 16, 4, 0.1))
