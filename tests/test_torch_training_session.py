"""Secret-shared checkpoints and resumable secure training through the
port's per-host walk, against the JAX package's, on the CPU.

``training.TrainingSession`` over ``LocalTrainingCluster`` with one
``CheckpointStore(FilesystemStorage)`` a party trains a
``LogregSGDTrainer`` at 8 rows x 3 features (``tests/test_training.py``'s
size), init and two epochs, ``steps_per_epoch`` 1 and 2 (and an
``MLPSGDTrainer`` with 4 hidden units, 1 step an epoch), under
``threefry`` and fixed keys: every party's committed ``#s0``/``#s1``
words and the exported weights equal the JAX package's (the JAX
``LocalMooseRuntime(use_jit=False)``, its per-host walk), and the
weights are within 1e-3 of ``reference_epoch`` (``tests/test_training.py:
255-257``).  A checkpoint directory written by either package resumes in
the other to the same words; a peer lost between an epoch's session and
its commit resumes bit-exact.  The trainers' graphs are the JAX
package's bytes, their constructors take its positional order, and what
is not ported names its ROADMAP item.

The JAX runs cost 5-25 s each on the CPU (its eager per-host kernels
compile per shape), so they run once, in a module fixture."""

import shutil

import numpy as np
import pytest

import moose_tpu as jm
from moose_tpu import serde as jserde
from moose_tpu.predictors import trainers as jtrainers
from moose_tpu.runtime import LocalMooseRuntime as JaxRuntime
from moose_tpu.storage import FilesystemStorage as JaxStorage
from moose_tpu.training import CheckpointStore as JaxStore
from moose_tpu.training import TrainingConfig as JaxConfig
from moose_tpu.training import TrainingSession as JaxSession
from moose_tpu.training import export as jexport
from moose_tpu.training.session import LocalTrainingCluster as JaxCluster

import moose_tpu_torch as tm
from moose_tpu_torch import flight, metrics
from moose_tpu_torch import serde as tserde
from moose_tpu_torch.dialects import logical, stacked
from moose_tpu_torch.errors import CheckpointError, PeerUnreachableError
from moose_tpu_torch.execution import interpreter
from moose_tpu_torch.predictors import trainers as ttrainers
from moose_tpu_torch.runtime import LocalMooseRuntime as PortRuntime
from moose_tpu_torch.storage import FilesystemStorage
from moose_tpu_torch.training import (
    CheckpointStore,
    TrainingConfig,
    TrainingSession,
    export,
)
from moose_tpu_torch.training.session import (
    GrpcTrainingCluster,
    LocalTrainingCluster,
)

from torch_parity import fixed_keys_env, prf, threefry  # noqa: F401

PARTIES = ["alice", "bob", "carole"]
ROWS, FEATURES, HIDDEN, EPOCHS = 8, 3, 4, 2
TOL = 1e-3  # tests/test_training.py:255-257


def _data(rows=ROWS, feats=FEATURES, seed=1):
    """tests/test_training.py's data."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, feats)) * 0.5
    y = (rng.uniform(size=(rows, 1)) > 0.5).astype(np.float64)
    return x, y


def _stores(root, store_cls=CheckpointStore, fs_cls=FilesystemStorage):
    return {p: store_cls(fs_cls(str(root / p)), party=p) for p in PARTIES}


def _words(stores, trainer):
    return {(p, k): np.asarray(stores[p].load(k)) for p in PARTIES
            for k in trainer.expected_staged()}


def _trainer(trainers, kind, steps):
    if kind == "mlp":
        return trainers.MLPSGDTrainer(FEATURES, HIDDEN, 0.1,
                                      steps_per_epoch=steps)
    return trainers.LogregSGDTrainer(FEATURES, 0.1, steps_per_epoch=steps)


def _port_run(root, steps, epochs=EPOCHS, cluster=None, config=None,
              kind="logreg"):
    """(report, committed words, session) of a port run over the
    stores under ``root``."""
    stores = _stores(root)
    runtime = PortRuntime(PARTIES, storage_mapping=stores, use_jit=False,
                          device="cpu")
    trainer = _trainer(ttrainers, kind, steps)
    cluster = (cluster or (lambda c: c))(LocalTrainingCluster(
        runtime, PARTIES))
    session = TrainingSession(trainer, cluster,
                              config or TrainingConfig(epochs=epochs))
    report = session.run(*_data())
    return report, _words(stores, trainer), session


def _jax_run(root, steps, epochs, kind="logreg"):
    stores = _stores(root, JaxStore, JaxStorage)
    trainer = _trainer(jtrainers, kind, steps)
    report = JaxSession(
        trainer, JaxCluster(JaxRuntime(PARTIES, storage_mapping=stores,
                                       use_jit=False), PARTIES),
        JaxConfig(epochs=epochs),
    ).run(*_data())
    return report, _words(stores, trainer)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX package's runs, under threefry and fixed keys: for each
    ``steps_per_epoch`` init and epoch 1, a copy of that directory, then
    epoch 2; the MLP's init and two epochs; and epoch 2 resumed from a
    directory the port wrote."""
    root = tmp_path_factory.mktemp("jax_training")
    out = {}
    with prf("threefry"), fixed_keys_env():
        for steps in (1, 2):
            _jax_run(root / f"s{steps}", steps, 1)
            shutil.copytree(root / f"s{steps}", root / f"s{steps}_epoch1")
            out["logreg", steps] = _jax_run(root / f"s{steps}", steps,
                                            EPOCHS)
        out["mlp", 1] = _jax_run(root / "mlp", 1, EPOCHS, kind="mlp")
        _port_run(root / "port_epoch1", 1, epochs=1)
        out["port_then_jax"] = _jax_run(root / "port_epoch1", 1, EPOCHS)
    out["root"] = root
    return out


@pytest.fixture
def fixed_keys(monkeypatch):
    monkeypatch.setenv("MOOSE_TPU_FIXED_KEYS", "torch-parity")
    monkeypatch.setenv("MOOSE_TPU_ALLOW_WEAK_PRF", "1")


@pytest.mark.parametrize("kind,steps", (("logreg", 1), ("logreg", 2),
                                        ("mlp", 1)))
def test_init_and_two_epochs_match_the_jax_package(runs, tmp_path, threefry,
                                                   fixed_keys, kind, steps):
    report, words, session = _port_run(tmp_path, steps, kind=kind)
    jax_report, jax_words = runs[kind, steps]
    assert report["ok"] and report["epochs_committed"] == [0, 1, 2]
    assert words.keys() == jax_words.keys()
    assert len(words) == 6 * len(session.trainer.state_shapes)
    for (party, key), want in jax_words.items():
        name = key[len(session.trainer.checkpoint_key) + 1:].split("#")[0]
        assert words[party, key].dtype == np.uint64
        assert words[party, key].shape == \
            (2,) + session.trainer.state_shapes[name]
        assert np.array_equal(words[party, key], want), (party, key)
    state = {name: session._initial_value(name, shape)
             for name, shape in session.trainer.state_shapes.items()}
    for _ in range(EPOCHS):
        state = session.trainer.reference_epoch(state, *_data())
    for name, want in state.items():
        assert np.array_equal(report["weights"][name],
                              jax_report["weights"][name])
        assert np.abs(report["weights"][name] - want).max() < TOL


def test_a_jax_checkpoint_directory_resumes_in_the_port(runs, tmp_path,
                                                        threefry, fixed_keys):
    # the state carried across: the JAX package's epoch-1 directory
    shutil.copytree(runs["root"] / "s1_epoch1", tmp_path / "ckpt")
    report, words, _ = _port_run(tmp_path / "ckpt", 1)
    assert report["epochs_skipped"] == [1]
    assert report["epochs_committed"] == [2]
    jax_report, jax_words = runs["logreg", 1]
    # the JAX run went to epoch 1 here, then on to epoch 2
    assert jax_report["epochs_skipped"] == [1]
    for key, want in jax_words.items():
        assert np.array_equal(words[key], want), key
    assert np.array_equal(report["weights"]["w"], jax_report["weights"]["w"])


def test_a_port_checkpoint_directory_resumes_in_the_jax_package(runs):
    report, words = runs["port_then_jax"]
    assert report["epochs_skipped"] == [1]
    assert report["epochs_committed"] == [2]
    _, want_words = runs["logreg", 1]
    for key, want in want_words.items():
        assert np.array_equal(words[key], want), key


class _LosePeerOnce:
    """Raises a retryable PeerUnreachableError once, after the
    ``fail_at``-th session ran and before its commit."""

    def __init__(self, cluster, fail_at):
        self.cluster, self.parties = cluster, cluster.parties
        self.fail_at, self.sessions = fail_at, 0

    def run(self, comp, arguments, timeout):
        out = self.cluster.run(comp, arguments, timeout)
        self.sessions += 1
        if self.sessions == self.fail_at:
            raise PeerUnreachableError("injected: peer lost before commit")
        return out

    def control(self, party, cmd, **args):
        return self.cluster.control(party, cmd, **args)


def test_a_lost_peer_resumes_bit_exact(tmp_path, threefry, fixed_keys):
    config = TrainingConfig(epochs=EPOCHS, backoff_base_s=0.01,
                            backoff_cap_s=0.02)
    clean, clean_words, _ = _port_run(tmp_path / "clean", 1, config=config)
    resumes = metrics.REGISTRY.value("moose_tpu_training_resumes_total")
    # sessions: init, epoch 1, epoch 2 -> lost after epoch 2's session
    resumed, words, _ = _port_run(
        tmp_path / "lost", 1, config=config,
        cluster=lambda c: _LosePeerOnce(c, fail_at=EPOCHS + 1))
    assert (clean["resumes"], resumed["resumes"]) == (0, 1)
    assert resumed["attempts"] == {0: 1, 1: 1, 2: 2}
    assert resumed["epochs_committed"] == [0, 1, 2]
    for key, want in clean_words.items():
        assert np.array_equal(words[key], want), key
    assert np.array_equal(resumed["weights"]["w"], clean["weights"]["w"])
    assert metrics.REGISTRY.value(
        "moose_tpu_training_resumes_total") == resumes + 1
    kinds = {e.get("kind") for e in flight.get_recorder().events()}
    assert {"epoch_resumed", "epoch_failed", "epoch_committed"} <= kinds
    # a fresh driver over the same stores replays nothing
    again, again_words, _ = _port_run(tmp_path / "lost", 1, config=config)
    assert again["epochs_skipped"] == [1, 2]
    assert again["epochs_committed"] == []
    assert np.array_equal(again["weights"]["w"], clean["weights"]["w"])
    for key, want in clean_words.items():
        assert np.array_equal(again_words[key], want), key


def test_constructors_take_the_reference_s_positional_order():
    # the queue 3 repair: the port took (n_features, learning_rate,
    # fixedpoint_dtype, steps_per_epoch), the reference (n_features,
    # learning_rate, checkpoint_key, fixedpoint_dtype, steps_per_epoch,
    # feature_range, weight_range)
    def both(build):
        return build(jtrainers, jm), build(ttrainers, tm)

    pairs = [
        both(lambda t, m: t.LogregSGDTrainer(
            4, 0.05, "ckpt/a", m.fixed(14, 23), 2, (-2.0, 2.0),
            (-0.5, 0.5))),
        both(lambda t, m: t.MLPSGDTrainer(
            4, 3, 0.2, "ckpt/b", m.fixed(24, 40), 1, (-3.0, 3.0),
            (-1.5, 1.5))),
        both(lambda t, m: t.LogregSGDTrainer(5)),
        both(lambda t, m: t.MLPSGDTrainer(5, 2)),
    ]
    for jtrainer, ttrainer in pairs:
        for attr in ("checkpoint_key", "learning_rate", "steps_per_epoch",
                     "feature_range", "weight_range", "n_features",
                     "state_shapes"):
            assert getattr(ttrainer, attr) == getattr(jtrainer, attr), attr
        assert ttrainer.fixedpoint_dtype.name == \
            jtrainer.fixedpoint_dtype.name
        assert (ttrainer.fixedpoint_dtype.fractional_precision
                == jtrainer.fixedpoint_dtype.fractional_precision)
        assert ttrainer.expected_staged() == jtrainer.expected_staged()
        assert ttrainer.range_specs(8) == jtrainer.range_specs(8)
        assert ttrainer.range_specs() == jtrainer.range_specs()
        for name, shape in ttrainer.state_shapes.items():
            assert ttrainer.state_key(name) == jtrainer.state_key(name)
            # the bootstrap weights seed from blake2b(checkpoint_key|name)
            got = TrainingSession(ttrainer, None)._initial_value(name, shape)
            want = JaxSession(jtrainer, None)._initial_value(name, shape)
            assert np.array_equal(got, want)


@pytest.mark.parametrize("graph", ("init", "epoch", "export"))
@pytest.mark.parametrize("kind", ("logreg", "mlp"))
def test_trainer_graphs_are_the_jax_package_s_bytes(kind, graph):
    def build(t, m):
        if kind == "logreg":
            trainer = t.LogregSGDTrainer(FEATURES, 0.1, steps_per_epoch=2)
        else:
            trainer = t.MLPSGDTrainer(FEATURES, 4, 0.1, steps_per_epoch=2)
        args = (ROWS,) if graph == "epoch" else ()
        comp = getattr(trainer, f"{graph}_computation")(*args)
        # memoized, as the runtimes' plan caches need
        assert getattr(trainer, f"{graph}_computation")(*args) is comp
        return comp

    want = jserde.serialize_computation(build(jtrainers, jm))
    got = tserde.serialize_computation(build(ttrainers, tm))
    assert got == want


def test_unported_parts_name_their_roadmap_items():
    with pytest.raises(NotImplementedError, match="item 12"):
        GrpcTrainingCluster(object())
    with pytest.raises(NotImplementedError, match="item 11"):
        export.hot_swap(object(), "logreg", np.ones((3, 1)))
    trainer = ttrainers.LogregSGDTrainer(FEATURES)
    with pytest.raises(NotImplementedError, match="item 13"):
        trainer._range_lint(trainer.epoch_computation(ROWS), ROWS)


def test_export_writes_the_jax_package_s_onnx(threefry):
    w = np.array([[0.5], [-0.25], [0.125]])
    raw = export.logreg_onnx_bytes(w)
    assert raw == jexport.logreg_onnx_bytes(w)
    assert export.logreg_onnx_bytes(w, np.array([0.3])) == \
        jexport.logreg_onnx_bytes(w, np.array([0.3]))
    assert export.onnx_digest(raw, 3, 64) == jexport.onnx_digest(raw, 3, 64)
    model = export.trained_predictor(w)
    assert type(model).__name__ == "LinearClassifier"
    x = _data()[0]
    out = PortRuntime(PARTIES, device="cpu").evaluate_computation(
        model.predictor_factory(), {"x": x})["output_0"]
    p = 1.0 / (1.0 + np.exp(-(x @ w)))
    assert np.abs(out - np.hstack([1.0 - p, p])).max() < 5e-3


@pytest.mark.parametrize("layout", (None, "auto", "stacked"))
def test_epoch_graphs_route_as_the_jax_runtime_routes_them(tmp_path, layout):
    stores = _stores(tmp_path)
    trainer = ttrainers.LogregSGDTrainer(FEATURES, 0.1)
    x, y = _data()
    plans = {}
    for use_jit in (False, True):
        runtime = PortRuntime(PARTIES, storage_mapping=stores,
                              use_jit=use_jit, layout=layout, device="cpu")
        # a CheckpointStore is kept as the object it is
        assert all(runtime.storage[p] is stores[p] for p in PARTIES)
        if use_jit is False:
            runtime.evaluate_computation(
                trainer.init_computation(),
                {"w": np.zeros((FEATURES, 1))})
            for store in stores.values():
                store.commit(0)
        assert runtime.layout_for(trainer.epoch_computation(ROWS)) == \
            "per-host"
        runtime.evaluate_computation(trainer.epoch_computation(ROWS),
                                     {"x": x, "y": y})
        plans[use_jit] = dict(runtime.last_plan)
        for store in stores.values():
            store.discard_staged()
    assert plans[False]["layout"] == plans[True]["layout"] == "per-host"
    # past the segment limit (one Sigmoid weighs 4,600): lowered under
    # use_jit, the walk without it
    assert (plans[True]["lowered"], plans[False]["lowered"]) == (True, False)


def test_the_checkpoints_stay_off_the_stacked_layout():
    # as the reference's stacked.supports refuses them, so the runtime
    # runs them per-host under every layout (the route test above); the
    # stacked walk itself refuses them before it starts
    comp = ttrainers.LogregSGDTrainer(FEATURES).epoch_computation(ROWS)
    assert not stacked.supports(comp)
    assert logical.unsupported_ops(comp) == []
    with pytest.raises(NotImplementedError,
                       match="LoadShares \\(the per-host layout runs it\\)"):
        interpreter.Interpreter("cpu", stacked).evaluate(
            comp, dict(zip("xy", _data())))


def test_a_plain_store_is_refused_by_the_cluster():
    runtime = PortRuntime(PARTIES, device="cpu")
    with pytest.raises(CheckpointError, match="must be a CheckpointStore"):
        LocalTrainingCluster(runtime, PARTIES)


def test_training_modules_import_no_jax_or_moose_tpu():
    # the own copies of the framework-neutral modules (metrics, flight,
    # training/checkpoint.py) and the rest of training/; the AST scan of
    # every port source (tests/test_torch_predictors.py) reads them too
    import subprocess
    import sys
    from pathlib import Path

    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import moose_tpu_torch.training, moose_tpu_torch.training.export, "
        "moose_tpu_torch.training.session, "
        "moose_tpu_torch.training.checkpoint, moose_tpu_torch.metrics, "
        "moose_tpu_torch.flight, moose_tpu_torch.parallel.spmd, "
        "moose_tpu_torch.execution.physical, "
        "moose_tpu_torch.compilation.lowering\n"
        "new = set(sys.modules) - before\n"
        "print(sorted(m for m in new if m.split('.')[0] in "
        "('jax', 'jaxlib', 'moose_tpu')))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code],
        cwd=Path(__file__).resolve().parent.parent, capture_output=True,
        text=True, check=True, timeout=120)
    assert out.stdout.strip() == "[]"
