"""BASELINE config 5's small ResNet through the port on the CPU: the
convnet predictor (``predictors/convnet_predictor.py``) imported from
ONNX bytes that both packages' ``resnet_block_onnx`` write alike, traced
into the same ops as the JAX package's, and run through the port's
LocalMooseRuntime and the JAX one (stacked layout, eager) under fixed
keys, under both threefry streams: the class probabilities are equal,
and within tests/test_conv.py's 5e-3 of chip_smoke.py's float64 forward
pass.  Then the import's own rules: weights shared by two nodes are
relaid once, and padded pools are refused where the protocol's zero
padding would change the result."""

import sys
from pathlib import Path

import numpy as np
import pytest

from moose_tpu.edsl import tracer as jtracer
from moose_tpu.predictors import from_onnx as jfrom_onnx
from moose_tpu.predictors import sklearn_export as jsk
from moose_tpu.runtime import LocalMooseRuntime as JaxRuntime

from moose_tpu_torch.edsl import tracer as ttracer
from moose_tpu_torch.native import ring_kernels as rk
from moose_tpu_torch.predictors import ConvNet
from moose_tpu_torch.predictors import from_onnx as tfrom_onnx
from moose_tpu_torch.predictors import onnx_proto as op
from moose_tpu_torch.predictors import sklearn_export as tsk
from moose_tpu_torch.runtime import LocalMooseRuntime as PortRuntime

from torch_parity import fixed_keys_env, prf

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

IDS = ["alice", "bob", "carole"]
# two images of 2 channels at 4x4, 3 mid channels: tests/test_stacked_
# backend.py:298's batch and channels at a smaller side (the JAX
# reference compiles its eager kernels once a shape)
SMALL = dict(seed=3, in_ch=2, mid_ch=3, size=4, n_classes=2)
FLOAT = op.TensorProto.FLOAT


def _ops(comp):
    return [(o.name, o.kind, o.placement_name, sorted(o.attributes))
            for o in comp.operations.values()]


@pytest.mark.parametrize("kwargs", (SMALL, {}), ids=("small", "defaults"))
def test_resnet_block_onnx_writes_the_reference_s_bytes(kwargs):
    (tmodel, tparams), (jmodel, jparams) = (
        sk.resnet_block_onnx(**kwargs) for sk in (tsk, jsk))
    assert tmodel.encode() == jmodel.encode()
    assert tparams.keys() == jparams.keys()
    for name in jparams:
        assert np.array_equal(tparams[name], jparams[name]), name


@pytest.mark.parametrize("stream", ("threefry", "threefry-pallas"))
def test_convnet_is_bit_identical_to_the_reference(stream):
    model, params = tsk.resnet_block_onnx(**SMALL)
    data = model.encode()
    jpred, tpred = jfrom_onnx(data), tfrom_onnx(data)
    assert isinstance(tpred, ConvNet)
    # the same ops, kinds and placements, in the same order: the draws
    # line up one for one
    assert _ops(ttracer.trace(tpred.predictor_factory())) == \
        _ops(jtracer.trace(jpred.predictor_factory()))
    x = np.random.default_rng(11).normal(size=(2, 2, 4, 4)) * 0.5
    with prf(stream), fixed_keys_env():
        want = JaxRuntime(IDS, layout="stacked", use_jit=False) \
            .evaluate_computation(jpred.predictor_factory(),
                                  {"x": x})["output_0"]
        before = dict(rk.LAUNCHES)
        got = PortRuntime(IDS, device="cpu").evaluate_computation(
            tpred.predictor_factory(), {"x": x})["output_0"]
        assert rk.LAUNCHES == before  # the CPU runs the plain versions
    want = np.asarray(want)
    assert got.dtype == np.float64 and got.shape == want.shape == (2, 2)
    # probabilities below 2 at fixed(24,40) decode exactly: equal floats
    # are equal ring words
    assert np.array_equal(got, want)
    assert np.abs(got - chip_smoke.resnet_reference(params, x)).max() \
        < chip_smoke.RESNET_TOL


def _init(name, arr):
    a32 = np.asarray(arr, dtype=np.float32)
    return op.TensorProto(name=name, dims=list(a32.shape), data_type=FLOAT,
                           raw_data=a32.tobytes())


def _model(nodes, inits, out_shape):
    graph = op.GraphProto(
        name="g", node=nodes,
        initializer=[_init(k, v) for k, v in inits.items()],
        input=[op.make_tensor_value_info("x", FLOAT, [None, 1, 4, 4])],
        output=[op.make_tensor_value_info("y", FLOAT, out_shape)],
    )
    return op.make_model(graph, producer_name="pytorch").encode()


def test_a_shared_weight_is_relaid_once():
    w = np.arange(9, dtype=np.float64).reshape(1, 1, 3, 3)
    data = _model([
        op.make_node("Conv", ["x", "w"], ["c0"], pads=[1, 1, 1, 1]),
        op.make_node("Conv", ["c0", "w"], ["y"], pads=[1, 1, 1, 1]),
    ], {"w": w}, [None, 1, 4, 4])
    got, want = tfrom_onnx(data), jfrom_onnx(data)
    assert np.array_equal(got.initializers["w"], np.transpose(w, (2, 3, 1, 0)))
    assert np.array_equal(got.initializers["w"], want.initializers["w"])
    assert _ops(ttracer.trace(got.predictor_factory())) == \
        _ops(jtracer.trace(want.predictor_factory()))


@pytest.mark.parametrize("case,match", (
    ("average", "count_include_pad=1"),
    ("max of a signed input", "non-negative"),
    ("max after a relu", None),
))
def test_padded_pools_follow_the_reference_s_rules(case, match):
    w = np.ones((1, 1, 1, 1))
    nodes = [op.make_node("Conv", ["x", "w"], ["c"])]
    pool_in = "c"
    if case == "max after a relu":
        nodes.append(op.make_node("Relu", ["c"], ["r"]))
        pool_in = "r"
    kind = "AveragePool" if case == "average" else "MaxPool"
    nodes.append(op.make_node(kind, [pool_in], ["y"], kernel_shape=[2, 2],
                              strides=[2, 2], pads=[1, 1, 1, 1]))
    data = _model(nodes, {"w": w}, [None, 1, 3, 3])
    for from_onnx, tracer in ((tfrom_onnx, ttracer), (jfrom_onnx, jtracer)):
        pred = from_onnx(data)
        if match is None:
            tracer.trace(pred.predictor_factory())
        else:
            with pytest.raises(ValueError, match=match):
                tracer.trace(pred.predictor_factory())
