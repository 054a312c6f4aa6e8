"""The port's programs of the reference's user journeys
(``moose_tpu_torch/examples/`` and ``moose_tpu_torch/tutorials/``)
held against the JAX package's scripts (``examples/*.py``,
``tutorials/*.py``) on the CPU.

- Each program's traced computations serialize to the JAX script's
  bytes (the JAX scripts are loaded from their paths; tracing compiles
  nothing), and the CLI tutorial writes the JAX script's ``.moose`` text.
  The ONNX programs' graphs are built by both packages from the same
  ONNX bytes.
- Each program's ``main`` runs with ``--device cpu`` at the JAX tests'
  smaller flags (``--samples 64``, ``--batch 4``) and passes its checks;
  the two without checks of their own are held here: the trained
  weights within 1e-3 of the same 8 steps in float64 and the scores
  within 5e-3 of the exact sigmoid, the ResNet within 5e-3 of
  ``chip_smoke.resnet_reference``.  Without a card, the default
  ``--device`` raises before any work.
- ``tests/test_torch_examples_words.py`` holds ``logistic_regression``'s
  ``predict`` and ``multichip_spmd``'s step and softmax word for word
  against the JAX package.
- The numpy fit lies within 1e-3 of sklearn's
  ``LogisticRegression().fit`` on both ONNX programs' data, and the
  split is ``train_test_split``'s.
- Every program's graph lints clean under the port's ``prancer`` (the
  counterpart of ``scripts/lint_examples.py``).
- The programs that start processes (the CLI tutorial and the two
  ``--grpc`` modes, 7-60 s each here) run on the card in
  ``chip_smoke.py``'s phase 27; here the worker spawner starts and stops
  three CPU comets.
"""

# no `from __future__ import annotations`: the eDSL reads the
# pm.Argument annotations of the graph below as objects
import ast
import contextlib
import importlib
import importlib.util
import io
import socket
from pathlib import Path

import numpy as np
import pytest

import moose_tpu as jm
from moose_tpu import predictors as jpredictors
from moose_tpu import serde as jserde
from moose_tpu.edsl import tracer as jtracer
from moose_tpu.predictors import sklearn_export as jsk

import moose_tpu_torch as tm
from moose_tpu_torch import predictors as tpredictors
from moose_tpu_torch import serde as tserde
from moose_tpu_torch import textual as ttextual
from moose_tpu_torch.bin.prancer import main as prancer
from moose_tpu_torch.compilation import DEFAULT_PASSES, compile_computation
from moose_tpu_torch.distributed.spawn import comet_workers
from moose_tpu_torch.edsl import tracer as ttracer
from moose_tpu_torch.errors import ConfigurationError
from moose_tpu_torch.examples import numpy_logistic
from moose_tpu_torch.predictors import sklearn_export as tsk

from torch_parity import load_chip_smoke

REPO = Path(__file__).resolve().parent.parent
PROGRAMS = (
    "examples.logistic_regression",
    "examples.onnx_predictor",
    "examples.resnet_inference",
    "examples.aes_inference",
    "tutorials.scientific_computing_multiple_players",
    "tutorials.ml_inference_with_onnx",
    "tutorials.interfacing_textual_and_cli",
    "tutorials.multichip_spmd",
)
# the programs run in process here, with the JAX tests' smaller flags
IN_PROCESS = {
    "examples.logistic_regression": [],
    "examples.onnx_predictor": [],
    "examples.resnet_inference": [],
    "examples.aes_inference": [],
    "tutorials.scientific_computing_multiple_players": ["--samples", "64"],
    "tutorials.ml_inference_with_onnx": ["--batch", "4"],
    "tutorials.multichip_spmd": [],
}
OK_LINES = {
    "examples.onnx_predictor": "OK",
    "examples.aes_inference": "OK",
    "tutorials.scientific_computing_multiple_players":
        "OK — secure result matches the plaintext statistic",
    "tutorials.ml_inference_with_onnx":
        "OK — encrypted inference matches the float64 model",
    "tutorials.multichip_spmd": "multichip SPMD tutorial OK",
}
TRAIN_TOL = 1e-3
SCORE_TOL = 5e-3
RESNET_TOL = 5e-3
FIT_TOL = 1e-3


def port(name):
    return importlib.import_module(f"moose_tpu_torch.{name}")


def jax_script(name):
    """The JAX package's script ``<name>.py`` as a module, loaded from its
    path (it imports moose_tpu only; nothing runs under __main__)."""
    path = REPO / f"{name.replace('.', '/')}.py"
    spec = importlib.util.spec_from_file_location(
        f"jax_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def jax_corr_inputs(jax_sci):
    """The JAX tutorial's ``corr_inputs``, which its ``run_grpc`` defines
    inside the function, as it defines it."""
    pm = jm
    alice, bob, carole = (pm.host_placement("alice"),
                          pm.host_placement("bob"),
                          pm.host_placement("carole"))
    rep = pm.replicated_placement("rep", players=[alice, bob, carole])

    @pm.computation
    def corr_inputs(
        a: pm.Argument(placement=alice, dtype=pm.float64),
        g: pm.Argument(placement=bob, dtype=pm.float64),
    ):
        with alice:
            af = pm.cast(a, dtype=jax_sci.FIXED)
        with bob:
            gf = pm.cast(g, dtype=jax_sci.FIXED)
        with rep:
            c = jax_sci.pearson_correlation_coefficient(af, gf)
        with carole:
            out = pm.cast(c, dtype=pm.float64)
        return out

    return corr_inputs


def onnx_pairs():
    """(label, JAX computation, port computation) of the three ONNX
    programs, each pair built from the same ONNX bytes."""
    _, onnx_bytes, _ = port("examples.onnx_predictor").model_and_query()
    model, x_test = port("tutorials.ml_inference_with_onnx").train_model()
    tutorial_bytes = tsk.logistic_regression_onnx(
        model, x_test.shape[1]).encode()
    resnet_bytes = port("examples.resnet_inference").model()[0].encode()
    assert resnet_bytes == jsk.resnet_block_onnx(
        seed=7, in_ch=3, mid_ch=4, size=8, n_classes=3)[0].encode()
    pairs = [(label, jpredictors.from_onnx(blob).predictor_factory(),
              tpredictors.from_onnx(blob).predictor_factory())
             for label, blob in (("onnx_predictor", onnx_bytes),
                                 ("ml_inference_with_onnx", tutorial_bytes))]
    return pairs + [(
        "resnet_inference",
        jpredictors.from_onnx(resnet_bytes).predictor_factory(
            fixedpoint_dtype=jm.fixed(24, 40)),
        tpredictors.from_onnx(resnet_bytes).predictor_factory(
            fixedpoint_dtype=tm.fixed(24, 40)))]


def graph_pairs():
    """(label, JAX computation, port computation) of every program's
    graph."""
    lr, aes = (jax_script(n) for n in ("examples.logistic_regression",
                                       "examples.aes_inference"))
    sci = jax_script("tutorials.scientific_computing_multiple_players")
    cli = jax_script("tutorials.interfacing_textual_and_cli")
    tlr, taes = (port(n) for n in ("examples.logistic_regression",
                                   "examples.aes_inference"))
    tsci = port("tutorials.scientific_computing_multiple_players")
    tcli = port("tutorials.interfacing_textual_and_cli")
    return [
        ("train", lr.train, tlr.train),
        ("predict", lr.predict, tlr.predict),
        ("secure_score", aes.secure_score, taes.secure_score),
        ("multiparty_correlation", sci.multiparty_correlation,
         tsci.multiparty_correlation),
        ("corr_inputs", jax_corr_inputs(sci), tsci.corr_inputs),
        ("my_computation", cli.my_computation, tcli.my_computation),
    ] + onnx_pairs()


@pytest.fixture(scope="module")
def graphs():
    return {label: (jtracer.trace(jc), ttracer.trace(tc))
            for label, jc, tc in graph_pairs()}


GRAPHS = ("train", "predict", "secure_score", "multiparty_correlation",
          "corr_inputs", "my_computation", "onnx_predictor",
          "ml_inference_with_onnx", "resnet_inference")


@pytest.mark.parametrize("label", GRAPHS)
def test_program_graph_is_the_jax_script_s(graphs, label):
    jtraced, ttraced = graphs[label]
    assert tserde.serialize_computation(ttraced) == \
        jserde.serialize_computation(jtraced)


def test_cli_tutorial_writes_the_jax_script_s_text(tmp_path):
    want = jax_script("tutorials.interfacing_textual_and_cli")
    got = port("tutorials.interfacing_textual_and_cli")
    text = got.comp_to_moose(got.my_computation, tmp_path / "port.moose")
    assert text == want.comp_to_moose(want.my_computation,
                                      tmp_path / "jax.moose")
    assert (tmp_path / "port.moose").read_text() == text


@pytest.mark.parametrize("label", GRAPHS)
def test_program_graph_lints_clean(graphs, label, tmp_path):
    path = tmp_path / f"{label}.moose"
    path.write_text(ttextual.to_textual(graphs[label][1]))
    with contextlib.redirect_stdout(io.StringIO()):
        assert prancer([str(path)]) == 0


def test_lowered_cli_graph_lints_clean(graphs, tmp_path):
    """The constants-only tutorial graph through the whole pipeline
    (lowering, pruning, networking): the graph the workers run."""
    lowered = compile_computation(graphs["my_computation"][1],
                                  passes=DEFAULT_PASSES)
    path = tmp_path / "lowered.moose"
    path.write_text(ttextual.to_textual(lowered))
    with contextlib.redirect_stdout(io.StringIO()):
        assert prancer([str(path)]) == 0


@pytest.fixture(scope="module")
def runs():
    """Each in-process program's ``main`` on the CPU: (return value,
    printed text).  On one intra-op thread: the programs' ring products
    are many small int64 matmuls, which ran 7x slower on the default
    threads when other test processes shared the CPU."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    out = {}
    try:
        for name, flags in IN_PROCESS.items():
            printed = io.StringIO()
            with contextlib.redirect_stdout(printed):
                value = port(name).main([*flags, "--device", "cpu"])
            out[name] = (value, printed.getvalue())
    finally:
        torch.set_num_threads(threads)
    return out


@pytest.mark.parametrize("name", sorted(OK_LINES))
def test_program_passes_its_checks_on_the_cpu(runs, name):
    assert OK_LINES[name] in runs[name][1].splitlines()


def test_logistic_regression_trains_and_scores(runs):
    """The secure training within 1e-3 of the same 8 SGD steps in
    float64 (exact sigmoid), the secure scores within 5e-3 of the exact
    sigmoid of the trained weights."""
    mod = port("examples.logistic_regression")
    result, printed = runs["examples.logistic_regression"]
    rng = np.random.default_rng(0)
    x = rng.normal(size=(mod.BATCH, mod.N_FEATURES))
    y = (x @ rng.normal(size=(mod.N_FEATURES, 1)) > 0).astype(np.float64)
    w = np.zeros((mod.N_FEATURES, 1))
    for _ in range(mod.STEPS):
        y_hat = 1 / (1 + np.exp(-(x @ w)))
        w = w - mod.LR * (x.T @ (y_hat - y)) / mod.BATCH
    assert np.abs(result["w"] - w).max() < TRAIN_TOL
    assert np.abs(result["scores"] - result["plain"]).max() < SCORE_TOL
    assert "weight correlation with generator:" in printed


def test_resnet_inference_within_the_float64_forward_pass(runs):
    result, printed = runs["examples.resnet_inference"]
    want = load_chip_smoke().resnet_reference(result["params"], result["x"])
    assert result["probs"].shape == want.shape == (4, 3)
    assert np.abs(result["probs"] - want).max() < RESNET_TOL
    assert "imported: ConvNet" in printed


@pytest.mark.parametrize("name", PROGRAMS)
def test_program_refuses_to_run_without_a_card_by_default(name):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(ConfigurationError, match="device='cpu'"):
        port(name).main([])


def test_programs_import_neither_sklearn_nor_benchmarks():
    paths = sorted((REPO / "moose_tpu_torch").glob("examples/*.py")) + \
        sorted((REPO / "moose_tpu_torch").glob("tutorials/*.py"))
    assert len(paths) == len(PROGRAMS) + 3  # two inits, the numpy fit
    for path in paths:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in (
                    "sklearn", "benchmarks", "jax", "moose_tpu"), (path, name)


@pytest.mark.parametrize("data", ["onnx_predictor", "ml_inference_with_onnx"])
def test_numpy_fit_is_sklearn_s(data):
    from sklearn.linear_model import LogisticRegression
    from sklearn.model_selection import train_test_split

    if data == "onnx_predictor":
        rng = np.random.default_rng(2)
        x = rng.normal(size=(200, 20))
        y = (rng.uniform(size=200) > 0.5).astype(int)
    else:
        rng = np.random.default_rng(14)
        x_all = rng.normal(size=(300, 10))
        w_true = rng.normal(size=(10,))
        y_all = (x_all @ w_true + 0.3 * rng.normal(size=300) > 0).astype(int)
        train, test = numpy_logistic.train_test_split(300, 0.2, 0)
        want = train_test_split(np.arange(300), test_size=0.2, random_state=0)
        assert np.array_equal(train, want[0])
        assert np.array_equal(test, want[1])
        x, y = x_all[train], y_all[train]
        _, x_test = port("tutorials.ml_inference_with_onnx").train_model()
        assert np.array_equal(x_test, x_all[test])
    sk = LogisticRegression().fit(x, y)
    fit = numpy_logistic.fit_logistic_regression(x, y)
    assert np.abs(fit.coef_ - sk.coef_).max() < FIT_TOL
    assert np.abs(fit.intercept_ - sk.intercept_).max() < FIT_TOL
    assert np.array_equal(fit.classes_, sk.classes_)
    assert np.abs(fit.predict_proba(x) - sk.predict_proba(x)).max() < FIT_TOL


def test_comet_workers_start_and_stop():
    """The ``--grpc`` programs' spawner: three CPU comets listen inside
    the block and none is left listening after it."""
    with comet_workers("cpu") as endpoints:
        assert sorted(endpoints) == ["alice", "bob", "carole"]
        for endpoint in endpoints.values():
            host, port_ = endpoint.split(":")
            socket.create_connection((host, int(port_)), timeout=5).close()
    for endpoint in endpoints.values():
        host, port_ = endpoint.split(":")
        with pytest.raises(OSError):
            socket.create_connection((host, int(port_)), timeout=5).close()
