"""The first slice end to end: the JAX LocalMooseRuntime (stacked layout)
and the port's, on the CPU, give bit-identical outputs for the eDSL
secure dot and the ONNX LinearRegressor under fixed keys and the
threefry PRF; plus the port's boundaries (imports, devices, the op kinds
it runs and those it refuses).  The logistic regression end to end:
tests/test_torch_logreg.py and tests/test_torch_classifier.py."""

import ast
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import moose_tpu as jm
from moose_tpu.dialects import stacked as jstacked
from moose_tpu.edsl import tracer as jtracer
from moose_tpu.predictors import from_onnx as jfrom_onnx
from moose_tpu.predictors import linear_predictor as jlp
from moose_tpu.predictors import sklearn_export as jsk
from moose_tpu.predictors import trainers as jtrainers
from moose_tpu.runtime import LocalMooseRuntime as JaxRuntime

import moose_tpu_torch as tm
from moose_tpu_torch.computation import Computation as TComputation
from moose_tpu_torch import interop
from moose_tpu_torch.dialects import logical as tlogical
from moose_tpu_torch.dialects import stacked as tstacked
from moose_tpu_torch.edsl import tracer as ttracer
from moose_tpu_torch.errors import ConfigurationError
from moose_tpu_torch.predictors import from_onnx as tfrom_onnx
from moose_tpu_torch.predictors import sklearn_export as tsk
from moose_tpu_torch.predictors import trainers as ttrainers
from moose_tpu_torch.runtime import LocalMooseRuntime as PortRuntime

from torch_parity import threefry  # noqa: F401  (fixture)

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

IDS = ["alice", "bob", "carole"]
PRECISIONS = ((24, 40), (14, 23))


@pytest.fixture
def fixed_keys(monkeypatch, threefry):
    monkeypatch.setenv("MOOSE_TPU_FIXED_KEYS", "torch-parity")
    monkeypatch.setenv("MOOSE_TPU_ALLOW_WEAK_PRF", "1")


def _only_output(outputs):
    assert list(outputs) == ["output_0"]
    return outputs["output_0"]


@pytest.mark.parametrize("precision", PRECISIONS)
def test_secure_dot_end_to_end_bit_identical(fixed_keys, precision):
    rng = np.random.default_rng(precision[1])
    args = {"x": rng.normal(size=(6, 5)), "y": rng.normal(size=(5, 4))}
    want = _only_output(
        JaxRuntime(IDS, layout="stacked").evaluate_computation(
            chip_smoke.secure_dot_computation(jm, precision), args
        )
    )
    got = _only_output(
        PortRuntime(IDS, device="cpu").evaluate_computation(
            chip_smoke.secure_dot_computation(tm, precision), args
        )
    )
    assert got.shape == (6, 4) and got.dtype == np.float64
    assert np.array_equal(got, want)
    assert np.abs(got - args["x"] @ args["y"]).max() < 2e-4


@pytest.mark.parametrize("precision", PRECISIONS)
def test_linear_regressor_end_to_end_bit_identical(fixed_keys, precision):
    rng = np.random.default_rng(precision[0])
    model = SimpleNamespace(coef_=rng.normal(size=5),
                            intercept_=np.array([0.375]))
    x = rng.normal(size=(8, 5))
    jpred = jfrom_onnx(jsk.linear_regressor_onnx(model, 5))
    want = _only_output(
        JaxRuntime(IDS, layout="stacked").evaluate_computation(
            jpred.predictor_factory(jm.fixed(*precision)), {"x": x}
        )
    )
    tpred = interop.linear_regressor_from_arrays(jpred.coeffs,
                                                 jpred.intercepts)
    runtime = PortRuntime(IDS, device="cpu")
    got = _only_output(runtime.evaluate_computation(
        tpred.predictor_factory(tm.fixed(*precision)), {"x": x}
    ))
    assert got.shape == (8, 1)
    assert np.array_equal(got, want)
    # the same model through the port's own ONNX import
    onnx_pred = tfrom_onnx(tsk.linear_regressor_onnx(model, 5))
    assert np.array_equal(onnx_pred.coeffs, jpred.coeffs)
    again = _only_output(runtime.evaluate_computation(
        onnx_pred.predictor_factory(tm.fixed(*precision)), {"x": x}
    ))
    assert np.array_equal(again, want)


def test_chip_smoke_linear_regressor_matches_float64():
    # the model chip_smoke.py serves on the card, cut to 8 features
    pred = chip_smoke.linear_regressor(np.random.default_rng(3), 8)
    x = np.random.default_rng(4).normal(size=(16, 8))
    out = _only_output(PortRuntime(IDS, device="cpu").evaluate_computation(
        pred.predictor_factory(), {"x": x}
    ))
    want = x @ pred.coeffs.T + pred.intercepts
    assert np.abs(out - want).max() < chip_smoke.LINREG_TOL


def _kinds_by_placement(comp):
    kinds = {"HostPlacement": set(), "ReplicatedPlacement": set(),
             "Mirrored3Placement": set()}
    for op in comp.operations.values():
        if op.kind in ("Input", "Output"):
            continue
        kinds[type(comp.placements[op.placement_name]).__name__].add(op.kind)
    return kinds


def _dense_and_tree_models(sk):
    """The MLPs (binary and multiclass), the pytorch network, the
    forests and the convnet (config 5's small ResNet), exported by ``sk``
    (either package's sklearn_export)."""
    rng = np.random.default_rng(0)
    weights, biases, acts = chip_smoke.network_layers(rng, 3, (2,), 3)
    forest = chip_smoke.forest_model(rng, 2, 2, 3)
    return [
        sk.mlp_onnx(chip_smoke.mlp_model(rng, 3, (2,)), 3, classifier=True),
        sk.mlp_onnx(chip_smoke.mlp_model(rng, 3, (2,), 3, "logistic"), 3,
                    classifier=True),
        sk.pytorch_nn_onnx(weights, biases, acts, 3),
        sk.random_forest_classifier_onnx(forest, 3),
        sk.random_forest_regressor_onnx(
            SimpleNamespace(estimators_=forest.estimators_), 3),
        sk.resnet_block_onnx(seed=3, in_ch=2, mid_ch=3, size=6,
                             n_classes=2)[0],
    ]


def _reference_host_kinds() -> set:
    """The op kinds the reference's ``logical._execute_host`` runs, read
    from its source: each ``kind == "X"`` and ``kind in (...)`` test and
    the kind tables it consults."""
    import inspect
    import re

    from moose_tpu.dialects import logical as jlogical

    src = inspect.getsource(jlogical._execute_host)
    kinds = set(re.findall(r'kind == "(\w+)"', src))
    for group in re.findall(r"kind in \(([^)]*)\)", src):
        kinds |= set(re.findall(r'"(\w+)"', group))
    return kinds | set(jlogical._HOST_MATH) | set(
        jlogical._HOST_STRUCTURAL_KINDS)


def _host_decrypt_matches_the_reference():
    """Both packages' ``logical._execute_host`` of one host Decrypt of
    two elements: equal ring words, the exact plaintext."""
    import jax.numpy as jnp

    from moose_tpu import dtypes as jdt
    from moose_tpu import values as jv
    from moose_tpu.dialects import logical as jlogical
    from moose_tpu.execution.session import EagerSession as JaxSession

    from moose_tpu_torch import dtypes as tdt
    from moose_tpu_torch import values as tv
    from moose_tpu_torch.dialects import aes as taes
    from moose_tpu_torch.execution.session import EagerSession

    key, nonce, vals = bytes(range(16)), bytes(range(9, 21)), [0.5, -3.0]
    wire = taes.encrypt_fixed_array(key, nonce, np.array(vals), 23)
    key_bits = np.repeat(taes.bytes_to_bits_be(key)[:, None], 2, axis=1)
    results = []
    for v, dt, asarray, sess, logical in (
        (jv, jdt, jnp.asarray, JaxSession(), jlogical),
        (tv, tdt, torch.as_tensor, EagerSession("cpu"), tlogical),
    ):
        op = SimpleNamespace(kind="Decrypt", name="decrypt_0",
                             signature=SimpleNamespace(return_type=(
                                 SimpleNamespace(dtype=dt.fixed(14, 23)))))
        k = v.HostAesKey(v.HostBitTensor(asarray(key_bits), "alice"),
                         "alice")
        ct = v.AesTensor(v.HostBitTensor(asarray(wire[:96]), "alice"),
                         v.HostBitTensor(asarray(wire[96:]), "alice"),
                         "alice")
        out = logical._execute_host(sess, None, op, SimpleNamespace(
            name="alice", kind="Host"), [k, ct])
        results.append(np.asarray(out.tensor.lo).view(np.uint64))
    assert np.array_equal(results[0], results[1])
    assert np.array_equal(results[1].view(np.int64),
                          np.round(np.array(vals) * 2.0 ** 23))


def test_port_supports_exactly_the_slice_kinds():
    model = SimpleNamespace(coef_=np.ones(3), intercept_=np.array([1.0]))
    binary = SimpleNamespace(coef_=np.ones((1, 3)), intercept_=np.ones(1),
                             classes_=np.arange(2))
    multi = SimpleNamespace(coef_=np.ones((3, 3)), intercept_=np.ones(3),
                            classes_=np.arange(3))
    graphs = [
        jtracer.trace(chip_smoke.secure_dot_computation(jm)),
        jtracer.trace(
            jfrom_onnx(jsk.linear_regressor_onnx(model, 3))
            .predictor_factory()
        ),
        jtracer.trace(
            jfrom_onnx(jsk.logistic_regression_onnx(binary, 3))
            .predictor_factory()
        ),
        # the one-vs-rest head of a 3-class LOGISTIC classifier
        jtracer.trace(
            jlp.LinearClassifier(
                np.ones((3, 3)), np.ones(3),
                post_transform=jlp.PostTransform.SIGMOID,
            ).predictor_factory()
        ),
        # the SOFTMAX head of a 3-class multinomial classifier
        jtracer.trace(
            jfrom_onnx(jsk.logistic_regression_onnx(multi, 3))
            .predictor_factory()
        ),
        # the SGD trainers' steps (traced already)
        jtrainers.LogregSGDTrainer(3).step_computation(4),
        jtrainers.MLPSGDTrainer(3, 2).step_computation(4),
        # BASELINE config 2: Load, string keys, Save
        jtracer.trace(chip_smoke.correlation_computation(jm)),
    ] + [
        # the dense and tree predictors
        jtracer.trace(jfrom_onnx(model).predictor_factory())
        for model in _dense_and_tree_models(jsk)
    ]
    traced = {k: set() for k in _kinds_by_placement(graphs[0])}
    for comp in graphs:
        for plc, kinds in _kinds_by_placement(comp).items():
            traced[plc] |= kinds
    # the correlation brings Load and Save, which the walk resolves; the
    # host kinds are the reference's _execute_host's, so the graphs'
    # are among them
    assert {"Load", "Save"} <= traced["HostPlacement"]
    assert tlogical.HOST_KINDS == _reference_host_kinds()
    assert traced["HostPlacement"] - {"Load", "Save"} <= tlogical.HOST_KINDS
    assert tlogical.MIR_KINDS == traced["Mirrored3Placement"]
    # the last host kind of the reference to come to the port's per-host
    # layout: Decrypt, the bit-sliced circuit on host bits, whose words
    # are the reference's
    _host_decrypt_matches_the_reference()
    # the replicated kinds are the reference's, and cover the graphs'
    assert tstacked.REP_KINDS == jstacked._REP_KINDS
    assert traced["ReplicatedPlacement"] <= tstacked.REP_KINDS
    assert {"Conv2D", "MaxPool2D"} <= traced["ReplicatedPlacement"]
    port_graphs = [
        chip_smoke.secure_dot_computation(tm),
        tfrom_onnx(tsk.linear_regressor_onnx(model, 3)).predictor_factory(),
        tfrom_onnx(tsk.logistic_regression_onnx(binary, 3))
        .predictor_factory(),
        interop.linear_classifier_from_arrays(
            np.ones((3, 3)), np.ones(3), "SIGMOID"
        ).predictor_factory(),
        tfrom_onnx(tsk.logistic_regression_onnx(multi, 3))
        .predictor_factory(),
        chip_smoke.correlation_computation(tm),
    ] + [
        tfrom_onnx(model).predictor_factory()
        for model in _dense_and_tree_models(tsk)
    ]
    assert all(
        tstacked.supports(ttracer.trace(g)) for g in port_graphs
    )
    assert tstacked.supports(
        ttrainers.LogregSGDTrainer(3).step_computation(4)
    )
    assert tstacked.supports(
        ttrainers.MLPSGDTrainer(3, 2).step_computation(4)
    )


def test_unported_kind_names_its_roadmap_item():
    # a replicated Inverse is no stacked kind: under "auto" the runtime
    # takes it to the per-host layout, as the JAX runtime does, where the
    # reference has no replicated Inverse either (moose_tpu/dialects/
    # logical.py:880): both raise the same error
    args = {"x": np.array([[2.0, 1.0], [1.0, 3.0]])}
    runtime = PortRuntime(IDS, device="cpu")
    comp = ttracer.trace(chip_smoke.inverse_computation(tm))
    assert not tstacked.supports(comp)
    assert runtime.layout_for(comp) == "per-host"
    with pytest.raises(NotImplementedError) as want:
        JaxRuntime(IDS, use_jit=False).evaluate_computation(
            chip_smoke.inverse_computation(jm), args)
    with pytest.raises(NotImplementedError) as got:
        runtime.evaluate_computation(comp, args)
    assert str(got.value) == str(want.value) == \
        "replicated op Inverse (inverse_0)"


def _recast_computation(pm):
    alice = pm.host_placement("alice")
    bob = pm.host_placement("bob")
    carole = pm.host_placement("carole")
    rep = pm.replicated_placement("rep", players=[alice, bob, carole])

    @pm.computation
    def recast(x: pm.Argument(alice, dtype=pm.float64)):
        with alice:
            xf = pm.cast(x, dtype=pm.fixed(24, 40))
        with rep:
            z = pm.cast(xf, dtype=pm.fixed(14, 23))
            z = pm.cast(z, dtype=pm.fixed(24, 40))
        with bob:
            out = pm.cast(z, dtype=pm.float64)
        return out

    return recast


def test_replicated_cast_moves_precision_bit_identical(fixed_keys):
    args = {"x": np.random.default_rng(5).normal(size=(3, 4))}
    want = _only_output(
        JaxRuntime(IDS, layout="stacked").evaluate_computation(
            _recast_computation(jm), args
        )
    )
    got = _only_output(PortRuntime(IDS, device="cpu").evaluate_computation(
        _recast_computation(tm), args
    ))
    assert np.array_equal(got, want)
    assert np.abs(got - args["x"]).max() < 2.0 ** -21


def test_runtime_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(ConfigurationError, match="device='cpu'"):
        PortRuntime(IDS)
    with pytest.raises(ConfigurationError):
        interop.ring_from_numpy(np.zeros(2, np.uint64))


def test_per_host_layout_is_refused(fixed_keys):
    # the per-host layout runs now: a precision recast (two truncations)
    # gives the JAX package's per-host words under fixed keys
    args = {"x": np.random.default_rng(5).normal(size=(3, 4))}
    want = _only_output(
        JaxRuntime(IDS, layout="per-host", use_jit=False)
        .evaluate_computation(_recast_computation(jm), args)
    )
    runtime = PortRuntime(IDS, layout="per-host", device="cpu")
    got = _only_output(runtime.evaluate_computation(
        _recast_computation(tm), args))
    assert runtime.last_plan["layout"] == "per-host"
    assert np.array_equal(got, want)
    with pytest.raises(ValueError, match="unknown layout"):
        PortRuntime(IDS, layout="sideways", device="cpu")


def test_interop_round_trips_words():
    lo = np.array([0, 1, (1 << 64) - 1, 1 << 63], dtype=np.uint64)
    hi = lo[::-1].copy()
    t_lo, t_hi = interop.ring_from_numpy(lo, hi, device="cpu")
    assert t_lo.dtype == torch.int64 and int(t_lo[2]) == -1
    back_lo, back_hi = interop.ring_to_numpy(t_lo, t_hi)
    assert np.array_equal(back_lo, lo) and np.array_equal(back_hi, hi)


def test_import_adds_no_jax_or_moose_tpu_module():
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import moose_tpu_torch, moose_tpu_torch.runtime, "
        "moose_tpu_torch.predictors, moose_tpu_torch.interop, "
        "moose_tpu_torch.native.build, moose_tpu_torch.dialects.pallas_prf, "
        "moose_tpu_torch.predictors.trainers, moose_tpu_torch.storage, "
        "moose_tpu_torch.dialects.mirrored, "
        "moose_tpu_torch.predictors.convnet_predictor, "
        "moose_tpu_torch.crypto.aes_prng, moose_tpu_torch.crypto.blake3, "
        "moose_tpu_torch.dialects.aes, moose_tpu_torch.dialects.bristol, "
        "moose_tpu_torch.serde, moose_tpu_torch.textual, "
        "moose_tpu_torch.compilation, moose_tpu_torch.compilation.print, "
        "moose_tpu_torch.elk_compiler, moose_tpu_torch.bin.elk, "
        "moose_tpu_torch.logger, moose_tpu_torch.dialects.host, "
        "moose_tpu_torch.dialects.additive, "
        "moose_tpu_torch.dialects.replicated, "
        "moose_tpu_torch.dialects.fixedpoint, "
        "moose_tpu_torch.dialects.logical, "
        "moose_tpu_torch.execution.session, "
        "moose_tpu_torch.execution.interpreter\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m.split('.')[0] in "
        "('jax', 'jaxlib', 'moose_tpu'))\n"
        "print(bad)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, check=True, timeout=120,
    )
    assert out.stdout.strip() == "[]"


def test_package_source_imports_no_jax_or_moose_tpu():
    paths = sorted((REPO / "moose_tpu_torch").rglob("*.py"))
    # the AES path's own copies of the framework-neutral modules, and
    # the codecs, compiler passes and CLI of computations from bytes
    scanned = {p.relative_to(REPO).as_posix() for p in paths}
    assert {"moose_tpu_torch/crypto/aes_prng.py",
            "moose_tpu_torch/crypto/blake3.py",
            "moose_tpu_torch/dialects/aes.py",
            "moose_tpu_torch/dialects/bristol.py",
            "moose_tpu_torch/serde.py", "moose_tpu_torch/textual.py",
            "moose_tpu_torch/elk_compiler.py", "moose_tpu_torch/logger.py",
            "moose_tpu_torch/bin/elk.py"} <= scanned
    # the per-host layout's dialects and session
    assert {f"moose_tpu_torch/{name}.py" for name in (
        "dialects/host", "dialects/additive", "dialects/replicated",
        "dialects/fixedpoint", "dialects/logical", "execution/session",
        "execution/interpreter")} <= scanned
    assert {f"moose_tpu_torch/compilation/{name}.py" for name in (
        "__init__", "typing", "pruning", "toposort", "networking",
        "well_formed", "print")} <= scanned
    for path in paths:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "moose_tpu"), (
                    f"{path.relative_to(REPO)} imports {name}"
                )


def test_chip_smoke_refuses_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py")], cwd=tmp_path,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert out.stdout == ""


def test_every_public_name_of_the_reference_is_a_top_level_name():
    # the names moose_tpu/__init__.py imports from its own modules
    tree = ast.parse((REPO / "moose_tpu" / "__init__.py").read_text())
    names = [alias.asname or alias.name for node in tree.body
             if isinstance(node, ast.ImportFrom) and node.level == 1
             for alias in node.names]
    assert len(names) == 87
    assert [n for n in names if not hasattr(tm, n)] == []
    assert set(names) <= set(tm.__all__)
    assert tm.fixed64(8, 27).name == "fixed64"
    assert tm.Computation is TComputation
