"""ConvNet predictor: encrypted inference for convolutional ONNX exports
(ResNet-style topologies with residual skips).

The port's copy of ``moose_tpu/predictors/convnet_predictor.py``, on the
port's eDSL and ring helpers.  BASELINE.json's config list includes
"ONNX MLP / small ResNet encrypted inference"; the reference's model zoo
(pymoose/pymoose/predictors/) is Gemm-only, so this predictor has no
reference counterpart.  It walks the ONNX graph in topological order and
rebuilds it op-by-op as replicated fixed-point eDSL (secure conv via
im2col and the secure dot's kernel, pooling via share-local patch
extraction, BatchNormalization folded into per-channel mirrored affine
constants).

Supported ONNX ops: Conv (group=1, dilation=1), BatchNormalization,
Relu, Sigmoid, Softmax, MaxPool, AveragePool, GlobalAveragePool, Add
(residual or bias), Flatten, Reshape, Gemm, MatMul, Identity.

Layout: ONNX convs are NCHW/OIHW; everything runs NHWC/HWIO internally
— the input is transposed once after sharing and conv weights are
permuted at import time.
"""

import numpy as np

import moose_tpu_torch as pm

from ..dialects import ring

from . import onnx_proto
from . import predictor
from . import predictor_utils


_ATTR_DEFAULTS = {"strides": [1, 1], "pads": [0, 0, 0, 0]}


def _attr(node, name, default=None):
    """Attribute *value* (ints / floats / scalar), with conv defaults."""
    attr = predictor_utils.find_attribute_in_node(node, name, enforce=False)
    if attr is None:
        return _ATTR_DEFAULTS.get(name, default)
    A = type(attr)
    if attr.type == A.INTS:
        return list(attr.ints)
    if attr.type == A.FLOATS:
        return list(attr.floats)
    if attr.type == A.INT:
        return attr.i
    if attr.type == A.FLOAT:
        return attr.f
    if attr.type == A.STRING:
        return attr.s.decode()
    raise ValueError(f"unsupported attribute type for {name}")


def _pads_to_padding(pads):
    # ONNX pads = [h_begin, w_begin, h_end, w_end]
    if not any(pads):
        return "VALID"
    return ((int(pads[0]), int(pads[2])), (int(pads[1]), int(pads[3])))


class ConvNet(predictor.Predictor):
    def __init__(self, nodes, initializers, input_name, output_name,
                 input_shape):
        super().__init__()
        self.nodes = nodes
        self.initializers = initializers  # name -> float64 ndarray
        self.input_name = input_name
        self.output_name = output_name
        self.input_shape = tuple(input_shape)  # (C, H, W), batch excluded
        self.n_classes = None

    # -- graph walking -----------------------------------------------------

    def _const(self, arr, dtype):
        return self.fixedpoint_constant(
            np.ascontiguousarray(arr), plc=self.mirrored, dtype=dtype
        )

    def predictor_fn(self, x, fixedpoint_dtype):
        # x: NCHW fixed -> NHWC
        c, h, w = self.input_shape
        env = {self.input_name: pm.transpose(x, axes=(0, 2, 3, 1))}
        shapes = {self.input_name: (-1, h, w, c)}  # batch symbolic
        # names whose values are provably non-negative (ReLU/Sigmoid
        # outputs and pools thereof) — required for padded MaxPool, whose
        # zero padding only equals ONNX's -inf padding in that regime
        nonneg: set = set()
        init = self.initializers

        for node in self.nodes:
            op = node.op_type
            ins = list(node.input)
            out = node.output[0]
            if op == "Conv":
                val, shp = self._apply_conv(
                    node, ins, env, shapes, fixedpoint_dtype
                )
            elif op == "BatchNormalization":
                val, shp = self._apply_batchnorm(
                    node, ins, env, shapes, fixedpoint_dtype
                )
            elif op == "Relu":
                val, shp = pm.relu(env[ins[0]]), shapes[ins[0]]
                nonneg.add(out)
            elif op == "Sigmoid":
                val, shp = pm.sigmoid(env[ins[0]]), shapes[ins[0]]
                nonneg.add(out)
            elif op == "Softmax":
                shp = shapes[ins[0]]
                val = pm.softmax(
                    env[ins[0]], axis=1, upmost_index=shp[1]
                )
            elif op in ("MaxPool", "AveragePool"):
                val, shp = self._apply_pool(
                    node, op, ins, env, shapes, nonneg
                )
                if ins[0] in nonneg:
                    nonneg.add(out)
            elif op == "GlobalAveragePool":
                # NHWC mean over H then W -> (N, C)
                val = pm.mean(pm.mean(env[ins[0]], axis=1), axis=1)
                shp = (-1, shapes[ins[0]][3])
            elif op == "Add":
                val, shp = self._apply_add(
                    ins, env, shapes, fixedpoint_dtype
                )
            elif op == "Flatten":
                in_shp = shapes[ins[0]]
                feat = int(np.prod([d for d in in_shp[1:]]))
                val = pm.reshape(env[ins[0]], (-1, feat))
                shp = (-1, feat)
            elif op == "Reshape":
                target = [int(v) for v in init[ins[1]].ravel()]
                in_shp = shapes[ins[0]]
                if target[0] in (0, -1):
                    target[0] = -1
                known = int(np.prod([d for d in in_shp[1:]]))
                target = [
                    known // int(np.prod([t for t in target[1:] if t > 0]))
                    if t == -1 and i > 0 else t
                    for i, t in enumerate(target)
                ]
                val = pm.reshape(env[ins[0]], tuple(target))
                shp = tuple(target)
            elif op in ("Gemm", "MatMul"):
                val, shp = self._apply_gemm(
                    node, op, ins, env, shapes, fixedpoint_dtype
                )
            elif op == "Identity":
                val, shp = env[ins[0]], shapes[ins[0]]
            else:
                raise ValueError(
                    f"unsupported ONNX op in ConvNet graph: {op}"
                )
            env[out] = val
            shapes[out] = shp

        self.n_classes = shapes[self.output_name][-1]
        return env[self.output_name]

    def _apply_conv(self, node, ins, env, shapes, dtype):
        init = self.initializers
        w = init[ins[1]]  # already HWIO (permuted at import)
        kh, kw, _, o = w.shape
        strides = tuple(int(s) for s in _attr(node, "strides"))
        group = int(_attr(node, "group", 1) or 1)
        if group != 1:
            raise ValueError("grouped convolution is not supported")
        dil = _attr(node, "dilations", [1, 1])
        if any(int(d) != 1 for d in dil):
            raise ValueError("dilated convolution is not supported")
        padding = _pads_to_padding(_attr(node, "pads"))
        kc = self._const(w, dtype)
        val = pm.conv2d(env[ins[0]], kc, strides=strides, padding=padding)
        if len(ins) > 2:  # bias over output channels (last axis in NHWC)
            val = pm.add(val, self._const(init[ins[2]].ravel(), dtype))
        n, h, wd, _ = shapes[ins[0]]
        (p0, p1), (q0, q1) = ring.resolve_padding(
            padding, h, wd, kh, kw, *strides
        )
        shp = (
            n,
            ring.conv_out_size(h, kh, strides[0], p0, p1),
            ring.conv_out_size(wd, kw, strides[1], q0, q1),
            o,
        )
        return val, shp

    def _apply_batchnorm(self, node, ins, env, shapes, dtype):
        init = self.initializers
        gamma, beta, mean, var = (init[n].ravel() for n in ins[1:5])
        eps = float(_attr(node, "epsilon", 1e-5) or 1e-5)
        scale = gamma / np.sqrt(var + eps)
        shift = beta - mean * scale
        val = pm.add(
            pm.mul(env[ins[0]], self._const(scale, dtype)),
            self._const(shift, dtype),
        )
        return val, shapes[ins[0]]

    def _apply_pool(self, node, op, ins, env, shapes, nonneg):
        pool = tuple(int(k) for k in _attr(node, "kernel_shape"))
        # ONNX pooling strides default to 1s (the _ATTR_DEFAULTS entry)
        strides = tuple(int(s) for s in _attr(node, "strides"))
        pads = _attr(node, "pads")
        padding = _pads_to_padding(pads)
        if (
            op == "AveragePool"
            and any(pads)
            and not int(_attr(node, "count_include_pad", 0) or 0)
        ):
            # our avg pool divides by the full window; ONNX's default
            # count_include_pad=0 divides by the valid count at borders
            raise ValueError(
                "AveragePool with padding requires count_include_pad=1 "
                "(window sums here always divide by the full pool size)"
            )
        if op == "MaxPool" and any(pads) and ins[0] not in nonneg:
            # zero padding only equals ONNX's -inf padding when the input
            # cannot be negative (ReLU/Sigmoid-preceded, the ResNet case)
            raise ValueError(
                "padded MaxPool requires a provably non-negative input "
                "(e.g. a preceding Relu); zero padding would otherwise "
                "override negative border maxima"
            )
        fn = pm.max_pool2d if op == "MaxPool" else pm.avg_pool2d
        val = fn(env[ins[0]], pool, strides=strides, padding=padding)
        n, h, w, c = shapes[ins[0]]
        (p0, p1), (q0, q1) = ring.resolve_padding(
            padding, h, w, pool[0], pool[1], *strides
        )
        shp = (
            n,
            ring.conv_out_size(h, pool[0], strides[0], p0, p1),
            ring.conv_out_size(w, pool[1], strides[1], q0, q1),
            c,
        )
        return val, shp

    def _apply_add(self, ins, env, shapes, dtype):
        init = self.initializers
        if ins[0] in env and ins[1] in env:  # residual skip
            return pm.add(env[ins[0]], env[ins[1]]), shapes[ins[0]]
        ten, const = (
            (ins[0], ins[1]) if ins[0] in env else (ins[1], ins[0])
        )
        return (
            pm.add(env[ten], self._const(init[const].ravel(), dtype)),
            shapes[ten],
        )

    def _apply_gemm(self, node, op, ins, env, shapes, dtype):
        init = self.initializers
        w = init[ins[1]]  # already (in, out) (transB undone at import)
        if op == "Gemm":
            alpha = float(_attr(node, "alpha", 1.0))
            beta = float(_attr(node, "beta", 1.0))
            if alpha != 1.0 or int(_attr(node, "transA", 0) or 0):
                raise ValueError(
                    "Gemm with alpha != 1 or transA is not supported"
                )
        else:
            beta = 1.0
        val = pm.dot(env[ins[0]], self._const(w, dtype))
        if op == "Gemm" and len(ins) > 2 and beta != 0.0:
            bias = init[ins[2]].ravel() * beta
            val = pm.add(val, self._const(bias, dtype))
        return val, (-1, w.shape[1])

    def __call__(
        self, x, fixedpoint_dtype=predictor_utils.DEFAULT_FIXED_DTYPE
    ):
        return self.predictor_fn(x, fixedpoint_dtype)

    # -- import ------------------------------------------------------------

    @classmethod
    def from_onnx(cls, model_proto):
        model_proto = onnx_proto.load_model(model_proto)
        graph = model_proto.graph
        initializers = {
            t.name: onnx_proto.tensor_to_numpy(t).astype(np.float64)
            for t in graph.initializer
        }
        nodes = []
        permuted = set()  # weight names already relaid (shared weights
        # referenced by several nodes must be permuted exactly once)
        for node in graph.node:
            if node.op_type == "Conv":
                name = node.input[1]
                if name not in permuted:  # OIHW -> HWIO, once
                    initializers[name] = np.transpose(
                        initializers[name], (2, 3, 1, 0)
                    )
                    permuted.add(name)
            if node.op_type == "Gemm":
                name = node.input[1]
                if int(_attr(node, "transB", 0) or 0) and (
                    name not in permuted
                ):  # (out, in) -> (in, out)
                    initializers[name] = initializers[name].T
                    permuted.add(name)
            nodes.append(node)
        inp = graph.input[0]
        shape = predictor_utils.find_input_shape(inp)
        dims = [
            getattr(d, "dim_value", 0) or -1 for d in shape
        ]
        if len(dims) != 4:
            raise ValueError(
                f"ConvNet expects NCHW input, found shape {dims}"
            )
        return cls(
            nodes,
            initializers,
            inp.name,
            graph.output[0].name,
            dims[1:],
        )
