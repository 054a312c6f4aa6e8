"""Export models to skl2onnx-style ONNX with the bundled protobuf
encoder: the port's copy of ``moose_tpu/predictors/sklearn_export.py``,
which writes the same bytes for the same arguments.  A model's weights
carry between the two packages as those bytes.

Only attributes are read (``coef_``, ``intercept_`` and ``classes_`` of
the linear models; ``coefs_``, ``intercepts_`` and ``activation`` of an
MLP; ``estimators_`` and ``classes_`` of a forest and, of each tree,
``tree_.children_left``, ``children_right``, ``feature``, ``threshold``,
``value`` and ``node_count``), so any object carrying them — a fitted
sklearn model or a ``types.SimpleNamespace`` built from numpy — exports.
"""

import numpy as np

from . import onnx_proto as op

FLOAT = op.TensorProto.FLOAT


def _model(nodes, n_features, initializers=(), producer="skl2onnx",
           n_outputs=1):
    graph = op.GraphProto(
        name="test_graph",
        node=list(nodes),
        initializer=list(initializers),
        input=[
            op.make_tensor_value_info("float_input", FLOAT, [None, n_features])
        ],
        output=[
            op.make_tensor_value_info("variable", FLOAT, [None, n_outputs])
        ],
    )
    return op.make_model(graph, producer_name=producer)


def linear_regressor_onnx(sk_model, n_features):
    coef = np.atleast_2d(np.asarray(sk_model.coef_, dtype=np.float64))
    intercept = np.atleast_1d(np.asarray(sk_model.intercept_))
    node = op.make_node(
        "LinearRegressor",
        ["float_input"],
        ["variable"],
        name="LinearRegressor",
        coefficients=[float(v) for v in coef.ravel()],
        intercepts=[float(v) for v in intercept.ravel()],
        targets=coef.shape[0],
    )
    return _model([node], n_features, n_outputs=coef.shape[0])


def logistic_regression_onnx(sk_model, n_features):
    """skl2onnx layout for LogisticRegression: binary models carry both
    class rows (the negated row for class 0) with the LOGISTIC
    post-transform; multinomial models carry raw rows with SOFTMAX."""
    coef = np.asarray(sk_model.coef_, dtype=np.float64)
    intercept = np.asarray(sk_model.intercept_, dtype=np.float64)
    n_classes = len(sk_model.classes_)
    if n_classes == 2:
        coefficients = np.concatenate([-coef, coef], axis=0)
        intercepts = np.concatenate([-intercept, intercept])
        post = "LOGISTIC"
    else:
        coefficients = coef
        intercepts = intercept
        post = "SOFTMAX"
    node = op.make_node(
        "LinearClassifier",
        ["float_input"],
        ["label", "probabilities"],
        name="LinearClassifier",
        coefficients=[float(v) for v in coefficients.ravel()],
        intercepts=[float(v) for v in intercepts.ravel()],
        classlabels_ints=[int(c) for c in sk_model.classes_],
        post_transform=post,
        multi_class=0,
    )
    return _model([node], n_features, n_outputs=n_classes)


def _tree_arrays(sk_tree):
    """Per-tree node arrays in ONNX convention: leaves get child id 0."""
    t = sk_tree.tree_
    left = [0 if c == -1 else int(c) for c in t.children_left]
    right = [0 if c == -1 else int(c) for c in t.children_right]
    feats = [max(int(f), 0) for f in t.feature]
    thresh = [float(v) for v in t.threshold]
    leaves = [i for i in range(t.node_count) if t.children_left[i] == -1]
    return left, right, feats, thresh, leaves, t.value


def random_forest_regressor_onnx(sk_model, n_features):
    attrs = {
        "nodes_treeids": [],
        "nodes_nodeids": [],
        "nodes_truenodeids": [],
        "nodes_falsenodeids": [],
        "nodes_featureids": [],
        "nodes_values": [],
        "target_treeids": [],
        "target_nodeids": [],
        "target_ids": [],
        "target_weights": [],
    }
    n_trees = len(sk_model.estimators_)
    for tid, est in enumerate(sk_model.estimators_):
        left, right, feats, thresh, leaves, value = _tree_arrays(est)
        for nid in range(len(left)):
            attrs["nodes_treeids"].append(tid)
            attrs["nodes_nodeids"].append(nid)
            attrs["nodes_truenodeids"].append(left[nid])
            attrs["nodes_falsenodeids"].append(right[nid])
            attrs["nodes_featureids"].append(feats[nid])
            attrs["nodes_values"].append(thresh[nid])
        for leaf in leaves:
            attrs["target_treeids"].append(tid)
            attrs["target_nodeids"].append(leaf)
            attrs["target_ids"].append(0)
            attrs["target_weights"].append(float(value[leaf][0][0]) / n_trees)
    node = op.make_node(
        "TreeEnsembleRegressor",
        ["float_input"],
        ["variable"],
        name="TreeEnsembleRegressor",
        post_transform="NONE",
        **attrs,
    )
    return _model([node], n_features)


def random_forest_classifier_onnx(sk_model, n_features):
    """Binary: one class_weights entry per leaf carrying P(class 1).
    Multiclass: sklearn/skl2onnx's shared-tree layout — one entry per
    (leaf, class) with post_transform NONE (exercises the importer's
    tree-duplication path)."""
    n_classes = len(sk_model.classes_)
    n_trees = len(sk_model.estimators_)
    attrs = {
        "nodes_treeids": [],
        "nodes_nodeids": [],
        "nodes_truenodeids": [],
        "nodes_falsenodeids": [],
        "nodes_featureids": [],
        "nodes_values": [],
        "class_treeids": [],
        "class_nodeids": [],
        "class_ids": [],
        "class_weights": [],
    }
    for tid, est in enumerate(sk_model.estimators_):
        left, right, feats, thresh, leaves, value = _tree_arrays(est)
        for nid in range(len(left)):
            attrs["nodes_treeids"].append(tid)
            attrs["nodes_nodeids"].append(nid)
            attrs["nodes_truenodeids"].append(left[nid])
            attrs["nodes_falsenodeids"].append(right[nid])
            attrs["nodes_featureids"].append(feats[nid])
            attrs["nodes_values"].append(thresh[nid])
        for leaf in leaves:
            counts = value[leaf][0]
            probs = counts / counts.sum()
            if n_classes == 2:
                attrs["class_treeids"].append(tid)
                attrs["class_nodeids"].append(leaf)
                attrs["class_ids"].append(1)
                attrs["class_weights"].append(float(probs[1]) / n_trees)
            else:
                for cid in range(n_classes):
                    attrs["class_treeids"].append(tid)
                    attrs["class_nodeids"].append(leaf)
                    attrs["class_ids"].append(cid)
                    attrs["class_weights"].append(float(probs[cid]) / n_trees)
    node = op.make_node(
        "TreeEnsembleClassifier",
        ["float_input"],
        ["label", "probabilities"],
        name="TreeEnsembleClassifier",
        post_transform="NONE",
        classlabels_int64s=[int(c) for c in sk_model.classes_],
        **attrs,
    )
    return _model([node], n_features, n_outputs=n_classes)


def mlp_onnx(sk_model, n_features, classifier=False):
    """skl2onnx MLP layout: stacked coefficient/intercepts initializers,
    one hidden-activation node whose output is named next_activations, and
    (for classifiers) a trailing ZipMap."""
    inits = []
    for i, (w, b) in enumerate(zip(sk_model.coefs_, sk_model.intercepts_)):
        suffix = "" if i == 0 else str(i)
        inits.append(op.make_initializer(f"coefficient{suffix}", w))
        inits.append(op.make_initializer(f"intercepts{suffix}", b))
    act_op = {"logistic": "Sigmoid", "relu": "Relu", "identity": "Identity"}[
        sk_model.activation
    ]
    nodes = [
        op.make_node("Cast", ["float_input"], ["cast_input"], to=1),
        op.make_node(act_op, ["pre_activations"], ["next_activations"]),
    ]
    if classifier:
        nodes.append(
            op.make_node("ZipMap", ["probabilities"], ["output_probability"])
        )
    return _model(nodes, n_features, initializers=inits)


def pytorch_nn_onnx(weights, biases, activations, n_features):
    """pytorch-export layout: Gemm nodes + {layer}.weight/.bias raw-data
    initializers holding (out, in)-shaped float32 weights."""
    inits = []
    nodes = []
    prev = "float_input"
    for i, (w, b) in enumerate(zip(weights, biases)):
        w32 = np.asarray(w, dtype=np.float32)
        b32 = np.asarray(b, dtype=np.float32)
        inits.append(
            op.TensorProto(
                name=f"fc{i}.weight",
                dims=list(w32.shape),
                data_type=FLOAT,
                raw_data=w32.tobytes(),
            )
        )
        inits.append(
            op.TensorProto(
                name=f"fc{i}.bias",
                dims=list(b32.shape),
                data_type=FLOAT,
                raw_data=b32.tobytes(),
            )
        )
        out = f"gemm_{i}"
        nodes.append(
            op.make_node(
                "Gemm",
                [prev, f"fc{i}.weight", f"fc{i}.bias"],
                [out],
                alpha=1.0,
                beta=1.0,
                transB=1,
            )
        )
        prev = out
        act = activations[i]
        if act is not None:
            out = f"act_{i}"
            nodes.append(op.make_node(act, [prev], [out]))
            prev = out
    return _model(nodes, n_features, initializers=inits, producer="pytorch")


def resnet_block_onnx(seed=0, in_ch=3, mid_ch=4, size=8, n_classes=3):
    """A miniature ResNet-style convnet ONNX export (pytorch layout:
    NCHW input, OIHW conv weights, Gemm head with transB):

        Conv3x3(pad 1) -> BN -> Relu -> MaxPool2x2
        -> [Conv3x3(pad 1) -> BN -> Relu -> Conv3x3(pad 1) -> BN] + skip
        -> Relu -> GlobalAveragePool -> Flatten -> Gemm -> Softmax

    Returns (model_proto, params dict) so tests can evaluate a reference
    implementation with the same weights."""
    rng = np.random.default_rng(seed)

    def conv_w(o, i, k=3):
        return (rng.normal(size=(o, i, k, k)) * (0.5 / (i * k))).astype(
            np.float64
        )

    p = {
        "w0": conv_w(mid_ch, in_ch),
        "g0": 1 + 0.1 * rng.normal(size=mid_ch),
        "b0": 0.1 * rng.normal(size=mid_ch),
        "m0": 0.05 * rng.normal(size=mid_ch),
        "v0": np.abs(1 + 0.1 * rng.normal(size=mid_ch)),
        "w1": conv_w(mid_ch, mid_ch),
        "g1": 1 + 0.1 * rng.normal(size=mid_ch),
        "b1": 0.1 * rng.normal(size=mid_ch),
        "m1": 0.05 * rng.normal(size=mid_ch),
        "v1": np.abs(1 + 0.1 * rng.normal(size=mid_ch)),
        "w2": conv_w(mid_ch, mid_ch),
        "g2": 1 + 0.1 * rng.normal(size=mid_ch),
        "b2": 0.1 * rng.normal(size=mid_ch),
        "m2": 0.05 * rng.normal(size=mid_ch),
        "v2": np.abs(1 + 0.1 * rng.normal(size=mid_ch)),
        "wf": (rng.normal(size=(n_classes, mid_ch)) * 0.5).astype(
            np.float64
        ),
        "bf": 0.1 * rng.normal(size=n_classes),
    }

    def init(name, arr):
        a32 = np.asarray(arr, dtype=np.float32)
        return op.TensorProto(
            name=name, dims=list(a32.shape), data_type=FLOAT,
            raw_data=a32.tobytes(),
        )

    inits = [init(k, v) for k, v in p.items()]
    nodes = [
        op.make_node("Conv", ["x", "w0"], ["c0"], strides=[1, 1],
                     pads=[1, 1, 1, 1], group=1),
        op.make_node("BatchNormalization",
                     ["c0", "g0", "b0", "m0", "v0"], ["n0"]),
        op.make_node("Relu", ["n0"], ["r0"]),
        op.make_node("MaxPool", ["r0"], ["p0"], kernel_shape=[2, 2],
                     strides=[2, 2]),
        op.make_node("Conv", ["p0", "w1"], ["c1"], strides=[1, 1],
                     pads=[1, 1, 1, 1], group=1),
        op.make_node("BatchNormalization",
                     ["c1", "g1", "b1", "m1", "v1"], ["n1"]),
        op.make_node("Relu", ["n1"], ["r1"]),
        op.make_node("Conv", ["r1", "w2"], ["c2"], strides=[1, 1],
                     pads=[1, 1, 1, 1], group=1),
        op.make_node("BatchNormalization",
                     ["c2", "g2", "b2", "m2", "v2"], ["n2"]),
        op.make_node("Add", ["n2", "p0"], ["sum"]),
        op.make_node("Relu", ["sum"], ["r2"]),
        op.make_node("GlobalAveragePool", ["r2"], ["gap"]),
        op.make_node("Gemm", ["gap", "wf", "bf"], ["logits"],
                     alpha=1.0, beta=1.0, transB=1),
        op.make_node("Softmax", ["logits"], ["variable"]),
    ]
    graph = op.GraphProto(
        name="resnet_block",
        node=nodes,
        initializer=inits,
        input=[
            op.make_tensor_value_info(
                "x", FLOAT, [None, in_ch, size, size]
            )
        ],
        output=[
            op.make_tensor_value_info("variable", FLOAT, [None, n_classes])
        ],
    )
    return op.make_model(graph, producer_name="pytorch"), p
