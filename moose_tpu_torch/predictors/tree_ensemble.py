"""Tree-ensemble predictors: gradient-boosted trees & random forests
(reference: ``pymoose/pymoose/predictors/tree_ensemble.py``).

TPU-first redesign of the evaluation strategy: the reference emits one
secure ``less`` per inner node (each of which lowers to a full bit
decomposition protocol).  Here ALL split comparisons across the whole
forest are batched into a single vectorized ``pm.less`` on a
(batch, total_inner_nodes) tensor — one bit-decomposition for the entire
ensemble — and the per-tree mux cascade then just indexes columns of the
resulting bit tensor.  Same oblivious semantics (every path is evaluated;
data-independent control flow), orders of magnitude fewer protocol rounds,
and XLA sees one big fused comparison instead of thousands of small ones.

The port's copy of ``moose_tpu/predictors/tree_ensemble.py``: it traces
the same ops in the same order (the one batched ``less`` first, then each
tree's mux cascade), so every draw index matches the JAX package's.
"""

import abc

import moose_tpu_torch as pm

from . import predictor
from . import predictor_utils as utils


class DecisionTreeRegressor(predictor.Predictor):
    def __init__(self, weights, children, split_conditions, split_indices):
        super().__init__()
        self.weights = weights
        self.left, self.right = children
        self.split_conditions = split_conditions
        self.split_indices = split_indices

    @classmethod
    def from_json(cls, tree_json):
        """Build from an XGBoost dump_model(dump_format="json") tree."""
        weights = dict(enumerate(tree_json["base_weights"]))
        left = _map_json_to_onnx_leaves(tree_json["left_children"])
        right = _map_json_to_onnx_leaves(tree_json["right_children"])
        split_conditions = tree_json["split_conditions"]
        split_indices = tree_json["split_indices"]
        return cls(weights, (left, right), split_conditions, split_indices)

    def aes_predictor_factory(self):
        raise NotImplementedError(
            f"{self.__class__.__name__} is not meant to be used directly as "
            "an AesPredictor model. Consider expressing your decision tree "
            "as a tree ensemble with another AesPredictor implementation."
        )

    def inner_nodes(self):
        """Indices of inner (split) nodes, in traversal-independent order."""
        return [
            n
            for n in range(len(self.left))
            if self.left[n] != 0 and self.right[n] != 0
        ]

    def __call__(self, x, n_features, rescale_factor, fixedpoint_dtype):
        del n_features  # shape comes from x; kept for API compatibility
        bits, col_of = _forest_split_bits(
            [self], x, fixedpoint_dtype, self.mirrored
        )
        return self.mux_tree(
            bits, col_of[id(self)], rescale_factor, fixedpoint_dtype
        )

    def mux_tree(self, bits, col_of_node, rescale_factor, fixedpoint_dtype):
        """Combine precomputed split bits into the tree's output via an
        oblivious mux cascade (reference _traverse_tree,
        tree_ensemble.py:37-62)."""
        leaf_weights = {
            ix: rescale_factor * w for ix, w in self.weights.items()
        }

        def traverse(node):
            left_child = self.left[node]
            right_child = self.right[node]
            if left_child != 0 and right_child != 0:
                selector = pm.index_axis(
                    bits, axis=1, index=col_of_node[node]
                )
                return pm.mux(
                    selector, traverse(left_child), traverse(right_child)
                )
            return self.fixedpoint_constant(
                leaf_weights[node], self.carole, dtype=fixedpoint_dtype
            )

        return traverse(0)


def _forest_split_bits(trees, x, fixedpoint_dtype, mirrored):
    """ONE batched secure comparison covering every split in the forest.

    Gathers the feature column of every inner node of every tree into a
    (batch, total_inner) tensor, compares against the matching threshold
    vector, and returns (bit tensor, {id(tree): {node: column}})."""
    columns = []
    thresholds = []
    col_of = {}
    for tree in trees:
        mapping = {}
        for node in tree.inner_nodes():
            mapping[node] = len(columns)
            columns.append(tree.split_indices[node])
            thresholds.append(float(tree.split_conditions[node]))
        col_of[id(tree)] = mapping

    if not columns:
        return None, col_of

    gathered = pm.concatenate(
        [
            pm.expand_dims(pm.index_axis(x, axis=1, index=c), 1)
            for c in columns
        ],
        axis=1,
    )
    thresh = predictor.Predictor.fixedpoint_constant(
        thresholds, plc=mirrored, dtype=fixedpoint_dtype
    )
    bits = pm.less(gathered, thresh)
    return bits, col_of


class TreeEnsemble(predictor.Predictor, metaclass=abc.ABCMeta):
    def __init__(self, trees, n_features, base_score, learning_rate):
        super().__init__()
        self.n_features = n_features
        self.trees = trees
        self.base_score = base_score
        self.learning_rate = learning_rate

    @classmethod
    @abc.abstractmethod
    def from_onnx(cls, model_proto):
        pass

    @abc.abstractmethod
    def post_transform(self, tree_scores, fixedpoint_dtype):
        pass

    def predictor_fn(self, x, fixedpoint_dtype):
        bits, col_of = _forest_split_bits(
            self.trees, x, fixedpoint_dtype, self.mirrored
        )
        forest_scores = [
            tree.mux_tree(
                bits,
                col_of[id(tree)],
                rescale_factor=self.learning_rate,
                fixedpoint_dtype=fixedpoint_dtype,
            )
            for tree in self.trees
        ]
        # degenerate (single-leaf) trees return a host-placed constant;
        # identity re-pins every score so variadic post-transform ops see a
        # uniform placement (reference tree_ensemble.py:92-99)
        return list(map(pm.identity, forest_scores))

    def __call__(self, x, fixedpoint_dtype=utils.DEFAULT_FIXED_DTYPE):
        tree_scores = self.predictor_fn(x, fixedpoint_dtype=fixedpoint_dtype)
        return self.post_transform(
            tree_scores, fixedpoint_dtype=fixedpoint_dtype
        )


class TreeEnsembleClassifier(TreeEnsemble):
    """Classifier over a forest (binary, multiclass via one-vs-rest).

    Args:
        trees: list of :class:`DecisionTreeRegressor`.
        n_features: expected input feature count.
        n_classes: number of output classes.
        base_score: ensemble bias term.
        learning_rate: leaf weight rescale factor.
        transform_output: whether probabilities are derived (sigmoid /
            softmax) from raw scores.
        tree_class_map: tree index -> class index (one-vs-rest bookkeeping).
    """

    def __init__(
        self,
        trees,
        n_features,
        n_classes,
        base_score,
        learning_rate,
        transform_output,
        tree_class_map,
    ):
        super().__init__(trees, n_features, base_score, learning_rate)
        self.n_classes = n_classes
        self.tree_class_map = tree_class_map
        self.transform_output = transform_output

    @classmethod
    def from_onnx(cls, model_proto):
        (
            forest_node,
            (nodes_treeids, left, right, split_conditions, split_indices),
            n_trees,
            n_features,
            base_score,
            learning_rate,
        ) = _onnx_base(model_proto, "TreeEnsembleClassifier")

        class_ids = _ints_attr(forest_node, "class_ids")
        class_nodeids = _ints_attr(forest_node, "class_nodeids")
        class_treeids = _ints_attr(forest_node, "class_treeids")
        class_weights = _floats_attr(forest_node, "class_weights")

        classlabels = _classlabels(forest_node)
        n_classes = len(classlabels)

        post_transform = bytes(
            utils.find_attribute_in_node(forest_node, "post_transform").s
        ).decode()

        if post_transform == "NONE" and n_classes > 2:
            # sklearn random forests store ONE tree per ONNX treeid whose
            # leaves carry per-class weight rows; expand to the
            # one-forest-per-class representation used here
            final_class_treeids = [
                class_id + tree_id * n_classes
                for (tree_id, class_id) in zip(class_treeids, class_ids)
            ]
            n_trees = len(set(final_class_treeids))
            if list(nodes_treeids) != sorted(nodes_treeids):
                raise ValueError(
                    "expected nodes_treeids to be sorted in ONNX file"
                )
            sublists = [
                [t for t in nodes_treeids if t == i]
                for i in sorted(set(nodes_treeids))
            ]
            repeated = [
                [n_classes * i + j for _ in sub]
                for j in range(n_classes)
                for i, sub in enumerate(sublists)
            ]
            final_nodes_treeids = [t for group in repeated for t in group]
        else:
            final_class_treeids = class_treeids
            final_nodes_treeids = nodes_treeids

        builders = [_TreeBuilder() for _ in range(n_trees)]
        n_nodes = len(left)
        for i, tree_id in enumerate(final_nodes_treeids):
            # i % n_nodes re-reads the same ONNX node list for each class's
            # copy when trees were duplicated above
            builders[tree_id].add_node(
                left[i % n_nodes], right[i % n_nodes],
                split_indices[i % n_nodes], split_conditions[i % n_nodes],
            )
        for tree_id, node_id, w in zip(
            final_class_treeids, class_nodeids, class_weights
        ):
            builders[tree_id].set_leaf(node_id, w)

        trees = [b.build() for b in builders]
        tree_class_map = dict(zip(final_class_treeids, class_ids))

        return cls(
            trees,
            n_features,
            n_classes,
            base_score,
            learning_rate,
            transform_output=post_transform != "NONE",
            tree_class_map=tree_class_map,
        )

    def post_transform(self, tree_scores, fixedpoint_dtype):
        if self.n_classes == 2:
            return self._maybe_sigmoid(tree_scores, fixedpoint_dtype)
        logit = self._ovr_logit(
            tree_scores, axis=1, fixedpoint_dtype=fixedpoint_dtype
        )
        if self.transform_output:
            return pm.softmax(logit, axis=1, upmost_index=self.n_classes)
        return logit

    def _maybe_sigmoid(self, tree_scores, fixedpoint_dtype):
        base_score = self.fixedpoint_constant(
            self.base_score, self.carole, dtype=fixedpoint_dtype
        )
        logit = pm.add(pm.add_n(tree_scores), base_score)
        pos_prob = pm.sigmoid(logit) if self.transform_output else logit
        pos_prob = pm.expand_dims(pos_prob, axis=1)
        one = self.fixedpoint_constant(
            1, plc=self.mirrored, dtype=fixedpoint_dtype
        )
        neg_prob = pm.sub(one, pos_prob)
        return pm.concatenate([neg_prob, pos_prob], axis=1)

    def _ovr_logit(self, tree_scores, axis, fixedpoint_dtype):
        ovr_results = [[] for _ in range(self.n_classes)]
        for tree_ix, model_ix in self.tree_class_map.items():
            ovr_results[model_ix].append(tree_scores[tree_ix])
        base_score = self.fixedpoint_constant(
            self.base_score, self.carole, dtype=fixedpoint_dtype
        )
        ovr_logits = [
            pm.add(pm.add_n(ovr), base_score) for ovr in ovr_results
        ]
        return pm.concatenate(
            [pm.expand_dims(ovr, axis=axis) for ovr in ovr_logits],
            axis=axis,
        )


class TreeEnsembleRegressor(TreeEnsemble):
    """Regressor over a forest (GBTs and random forests)."""

    @classmethod
    def from_onnx(cls, model_proto):
        (
            forest_node,
            (nodes_treeids, left, right, split_conditions, split_indices),
            n_trees,
            n_features,
            base_score,
            learning_rate,
        ) = _onnx_base(model_proto, "TreeEnsembleRegressor")

        target_nodeids = _ints_attr(forest_node, "target_nodeids")
        target_treeids = _ints_attr(forest_node, "target_treeids")
        target_weights = _floats_attr(forest_node, "target_weights")

        builders = [_TreeBuilder() for _ in range(n_trees)]
        for i, tree_id in enumerate(nodes_treeids):
            builders[tree_id].add_node(
                left[i], right[i], split_indices[i], split_conditions[i]
            )
        for tree_id, node_id, w in zip(
            target_treeids, target_nodeids, target_weights
        ):
            builders[tree_id].set_leaf(node_id, w)

        trees = [b.build() for b in builders]
        return cls(trees, n_features, base_score, learning_rate)

    def post_transform(self, tree_scores, fixedpoint_dtype):
        base_score = self.fixedpoint_constant(
            self.base_score, self.carole, dtype=fixedpoint_dtype
        )
        return pm.add(base_score, pm.add_n(tree_scores))


class _TreeBuilder:
    """Accumulates one tree's flat ONNX node arrays and leaf weights,
    then materializes a :class:`DecisionTreeRegressor`."""

    def __init__(self):
        self.left: list = []
        self.right: list = []
        self.split_indices: list = []
        self.split_conditions: list = []
        self.weights: dict = {}

    def add_node(self, left, right, split_index, split_condition):
        self.left.append(left)
        self.right.append(right)
        self.split_indices.append(split_index)
        self.split_conditions.append(split_condition)

    def set_leaf(self, node_id, weight):
        self.weights[node_id] = weight

    def build(self) -> "DecisionTreeRegressor":
        return DecisionTreeRegressor(
            weights=self.weights,
            children=(self.left, self.right),
            split_conditions=self.split_conditions,
            split_indices=self.split_indices,
        )


def _map_json_to_onnx_leaves(json_leaves):
    return [0 if child == -1 else child for child in json_leaves]


def _ints_attr(node, name):
    attr = utils.find_attribute_in_node(node, name)
    if attr.type != 7:  # INTS
        raise ValueError(f"{name} must be of type INTS, found other.")
    return list(attr.ints)


def _floats_attr(node, name):
    attr = utils.find_attribute_in_node(node, name)
    if attr.type != 6:  # FLOATS
        raise ValueError(f"{name} must be of type FLOATS, found other.")
    return list(attr.floats)


def _classlabels(node):
    ints = utils.find_attribute_in_node(
        node, "classlabels_int64s", enforce=False
    )
    strings = utils.find_attribute_in_node(
        node, "classlabels_strings", enforce=False
    )
    if ints is not None and len(ints.ints):
        return list(ints.ints)
    if strings is not None and len(strings.strings):
        return list(strings.strings)
    raise ValueError("TreeEnsembleClassifier carries no class labels")


def _onnx_base(model_proto, forest_node_name):
    forest_node = utils.find_node_in_model_proto(
        model_proto, forest_node_name, enforce=False
    )
    if forest_node is None:
        raise ValueError(
            "Incompatible ONNX graph provided: graph must contain a "
            f"{forest_node_name} operator."
        )

    nodes_treeids = _ints_attr(forest_node, "nodes_treeids")
    left = _ints_attr(forest_node, "nodes_truenodeids")
    right = _ints_attr(forest_node, "nodes_falsenodeids")
    split_conditions = _floats_attr(forest_node, "nodes_values")
    split_indices = _ints_attr(forest_node, "nodes_featureids")

    n_trees = len(set(nodes_treeids))

    n_features = utils.input_n_features(model_proto)

    n_split_indices = len(set(split_indices))
    largest_split_index = max(split_indices)
    if n_split_indices > n_features or largest_split_index >= n_features:
        raise ValueError(
            f"In the ONNX file, the input shape has {n_features} features "
            f"and there are {n_split_indices} distinct split indices with "
            f"the largest index {largest_split_index}. Validate you set "
            "correctly the `initial_types` when converting your model to "
            "ONNX."
        )

    base_score_attr = utils.find_attribute_in_node(
        forest_node, "base_values", enforce=False
    )
    base_score = (
        0.0 if base_score_attr is None else float(base_score_attr.floats[0])
    )

    # ONNX leaf weights are already scaled by the learning rate
    learning_rate = 1.0

    tree_args = (nodes_treeids, left, right, split_conditions, split_indices)
    return (
        forest_node,
        tree_args,
        n_trees,
        n_features,
        base_score,
        learning_rate,
    )
