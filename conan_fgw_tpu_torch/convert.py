"""Map a flax model's parameter tree onto the port's ``state_dict``: a
``ConanModel``'s or one of the aux heads' (``models/aux_heads.py``).

``params_from_flax`` takes the flax tree as nested dicts of numpy arrays
(with or without the top-level ``"params"`` key). Flax ``Dense`` kernels are
``(in, out)`` and become torch ``Linear`` weights ``(out, in)``; embedding
tables, the raw cfconv filter parameters, the GAT attention vectors,
DimeNet's ``bilinear`` and ``bessel_freq`` and the LayerNorms' scales and
biases are copied as they are, and so are ViSNet's optional
``VecLayerNorm`` weights and RBF means and betas. The backbone's rules follow the tree: ViSNet's
has ``layers_0``, DimeNet's ``bessel_freq``, SchNet's neither. A
classification tree (its head has ``Dense_1``) maps ``head/Dense_i`` to
``head.lins.i`` and ``self_attention/Dense_i`` to ``self_attention.qkv.i``;
a regression tree's ``head/Dense_0`` is ``head``. An aux head's tree has no
``backbone``: its top-level ``SchNet3D_0`` becomes ``schnet`` (the attention
head's ``Dense_0..3`` ``q``, ``k``, ``v`` and ``head``, the others'
``Dense_0`` ``head``), ``GAT2D_0`` ``gat``, and an ESAN variant's module
(``AverageConformerESAN_0``, ...) ``net``, with its ``siamese``,
``info_sharing``, GATs, ``deep_sets/Dense_0`` and ``transformation`` under
it. A SchNet's covalent ``blocks_cov_i`` map as its ``blocks_i`` do. A
tree of one ``Dense_0`` is an ``AttentionLayer``'s, whose ``lin`` it is. A leaf
that no rule maps raises.
``state_dict_from_flax_checkpoint`` does the same for a parameter
checkpoint file of the JAX package, reading it with numpy alone.
"""

from __future__ import annotations

import re

import numpy as np
import torch

# (flax path regex, torch name template, transpose)


def _dense(src: str, dst: str) -> tuple:
    """A flax ``Dense`` at ``src`` as the torch ``Linear`` ``dst``."""
    return ((rf"{src}/kernel", f"{dst}.weight", True), (rf"{src}/bias", f"{dst}.bias", False))


def _schnet(src: str, dst: str) -> tuple:
    """A flax ``SchNet3D`` at ``src`` (its radius blocks ``blocks_i``, its
    covalent ones ``blocks_cov_i``, the embedding and the heads) as the
    port's ``SchNet3D`` at ``dst``."""
    block = rf"{src}/(blocks(?:_cov)?)_(\d+)"
    return (
        (rf"{block}/(filter_[wb][12])", dst + ".{0}.{1}.{2}", False),
        (rf"{block}/Dense_0/kernel", dst + ".{0}.{1}.lin1.weight", True),
        (rf"{block}/Dense_1/kernel", dst + ".{0}.{1}.lin2.weight", True),
        (rf"{block}/Dense_1/bias", dst + ".{0}.{1}.lin2.bias", False),
        (rf"{block}/Dense_2/kernel", dst + ".{0}.{1}.lin.weight", True),
        (rf"{block}/Dense_2/bias", dst + ".{0}.{1}.lin.bias", False),
        (rf"{src}/embedding/embedding", f"{dst}.embedding.weight", False),
        (rf"{src}/(lin[12](?:_bary)?)/kernel", dst + ".{0}.weight", True),
        (rf"{src}/(lin[12](?:_bary)?)/bias", dst + ".{0}.bias", False),
    )


def _gat(src: str, dst: str) -> tuple:
    """A flax ``GAT2D`` at ``src`` as the port's ``GAT2D`` at ``dst``."""
    return (
        (rf"{src}/DenseGATConv_(\d+)/Dense_0/kernel", dst + ".convs.{0}.lin.weight", True),
        (rf"{src}/DenseGATConv_(\d+)/Dense_1/kernel", dst + ".convs.{0}.lin_edge.weight", True),
        (rf"{src}/DenseGATConv_(\d+)/(att_src|att_dst|att_edge|bias)", dst + ".convs.{0}.{1}",
         False),
    )


_SCHNET = _schnet("backbone", "backbone")
_VISNET = (
    (r"backbone/(neighbor_embedding_z)/embedding", "backbone.{0}.weight", False),
    (r"backbone/(prior_model(?:_bary)?)/Embed_0/embedding", "backbone.{0}.embedding.weight", False),
    (r"backbone/(neighbor_distance_proj|neighbor_combine|edge_proj)/kernel",
     "backbone.{0}.weight", True),
    (r"backbone/(neighbor_distance_proj|neighbor_combine|edge_proj)/bias", "backbone.{0}.bias", False),
    (r"backbone/layers_(\d+)/LayerNorm_0/scale", "backbone.layers.{0}.layernorm.weight", False),
    (r"backbone/layers_(\d+)/LayerNorm_0/bias", "backbone.layers.{0}.layernorm.bias", False),
    (r"backbone/layers_(\d+)/(\w+_proj)/kernel", "backbone.layers.{0}.{1}.weight", True),
    (r"backbone/layers_(\d+)/(\w+_proj)/bias", "backbone.layers.{0}.{1}.bias", False),
    # the options: trainable_vecnorm's weights, trainable_rbf's means and betas
    (r"backbone/layers_(\d+)/VecLayerNorm_0/weight", "backbone.layers.{0}.vec_layernorm.weight",
     False),
    (r"backbone/vec_out_norm/weight", "backbone.vec_out_norm.weight", False),
    (r"backbone/rbf_(means|betas)", "backbone.rbf.{0}", False),
    (r"backbone/out_norm/scale", "backbone.out_norm.weight", False),
    (r"backbone/out_norm/bias", "backbone.out_norm.bias", False),
    (r"backbone/(output_model(?:_bary)?)/GatedEquivariantBlock_(\d)/(vec[12]_proj)/kernel",
     "backbone.{0}.blocks.{1}.{2}.weight", True),
    (r"backbone/(output_model(?:_bary)?)/GatedEquivariantBlock_(\d)/Dense_(\d)/kernel",
     "backbone.{0}.blocks.{1}.lins.{2}.weight", True),
    (r"backbone/(output_model(?:_bary)?)/GatedEquivariantBlock_(\d)/Dense_(\d)/bias",
     "backbone.{0}.blocks.{1}.lins.{2}.bias", False),
)
# an interaction block's Dense_i, in the order flax numbers them
_DIMENET_BLOCK = ("lin_rbf", "lin_sbf", "lin_ji", "lin_kj", "lin")
_DIMENET = (
    (r"backbone/bessel_freq", "backbone.bessel_freq", False),
    (r"backbone/(edge_emb_dense|rbf_emb)/kernel", "backbone.{0}.weight", True),
    (r"backbone/(edge_emb_dense|rbf_emb)/bias", "backbone.{0}.bias", False),
    *((rf"backbone/blocks_(\d+)/Dense_{i}/kernel", f"backbone.blocks.{{0}}.{name}.weight", True)
      for i, name in enumerate(_DIMENET_BLOCK)),
    *((rf"backbone/blocks_(\d+)/Dense_{i}/bias", f"backbone.blocks.{{0}}.{name}.bias", False)
      for i, name in enumerate(_DIMENET_BLOCK)),
    (r"backbone/blocks_(\d+)/ResidualLayer_(\d+)/Dense_(\d)/kernel",
     "backbone.blocks.{0}.residuals.{1}.lins.{2}.weight", True),
    (r"backbone/blocks_(\d+)/ResidualLayer_(\d+)/Dense_(\d)/bias",
     "backbone.blocks.{0}.residuals.{1}.lins.{2}.bias", False),
    (r"backbone/blocks_(\d+)/bilinear", "backbone.blocks.{0}.bilinear", False),
    (r"backbone/outputs_(\d+)/Dense_(\d+)/kernel", "backbone.outputs.{0}.lins.{1}.weight", True),
    (r"backbone/outputs_(\d+)/Dense_(\d+)/bias", "backbone.outputs.{0}.lins.{1}.bias", False),
)
_COMMON = (
    (r"backbone/embedding/embedding", "backbone.embedding.weight", False),
    *_gat("gat", "gat"),
    (r"(t3d|tcov|tbary)/kernel", "{0}.weight", True),
    (r"(t3d|tcov|tbary)/bias", "{0}.bias", False),
)
_REGRESSION_HEAD = (
    (r"head/Dense_0/kernel", "head.weight", True),
    (r"head/Dense_0/bias", "head.bias", False),
)
_CLASSIFICATION_HEAD = (
    (r"head/Dense_([0-2])/kernel", "head.lins.{0}.weight", True),
    (r"head/Dense_([0-2])/bias", "head.lins.{0}.bias", False),
    (r"self_attention/Dense_([0-2])/kernel", "self_attention.qkv.{0}.weight", True),
    (r"self_attention/Dense_([0-2])/bias", "self_attention.qkv.{0}.bias", False),
)


def _flatten(tree, prefix=""):
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, dict):
            yield from _flatten(val, path)
        else:
            yield path, val


# the ESAN variants' flax module names (``ESANAggregation``'s child)
_ESAN = ("AverageConformerESAN_0", "GeometryInducedESAN_0", "Geometry2DInducedESAN_0")


def _conan_rules(tree: dict) -> tuple:
    head = _CLASSIFICATION_HEAD if "Dense_1" in tree.get("head", {}) else _REGRESSION_HEAD
    backbone = tree["backbone"]
    rules = (_VISNET if "layers_0" in backbone else _DIMENET if "bessel_freq" in backbone
             else _SCHNET)
    return _COMMON + rules + head


def _aux_rules(tree: dict) -> tuple:
    """The rules of an aux head's tree (``models/aux_heads.py``), told
    apart by its top-level modules."""
    if set(tree) == {"Dense_0"} and set(tree["Dense_0"]) == {"kernel", "bias"}:
        return _dense("Dense_0", "lin")  # models/attention.py::AttentionLayer
    if "SchNet3D_0" in tree:
        # the attention head's Dense_0..3 are q, k, v and the head
        heads = ("q", "k", "v", "head") if "Dense_3" in tree else ("head",)
        dense = (r for i, name in enumerate(heads) for r in _dense(f"Dense_{i}", name))
        return (*_schnet("SchNet3D_0", "schnet"), *dense)
    if "GAT2D_0" in tree:
        return (*_gat("GAT2D_0", "gat"), *_dense("Dense_0", "head"))
    esan = [name for name in _ESAN if name in tree]
    if len(esan) != 1:
        raise KeyError(f"flax tree with top-level modules {sorted(tree)} is no model of the port")
    src = esan[0]
    return (*_schnet(f"{src}/siamese", "net.siamese"),
            *_schnet(f"{src}/info_sharing", "net.info_sharing"),
            *(r for g in ("gat_2d", "gat_rbf", "gat_sub") for r in _gat(f"{src}/{g}", f"net.{g}")),
            *_dense(f"{src}/deep_sets/Dense_0", "net.deep_sets.lin"),
            *_dense(f"{src}/transformation", "net.transformation"),
            *_dense("Dense_0", "head"))


def params_from_flax(flax_params) -> dict[str, torch.Tensor]:
    """Return a ``state_dict`` for ``ConanModel`` or an aux head from flax
    parameters; the tree's top-level keys tell which model it is."""
    tree = flax_params.get("params", flax_params)
    rules = _conan_rules(tree) if "backbone" in tree else _aux_rules(tree)
    state = {}
    for path, leaf in _flatten(tree):
        for pattern, template, transpose in rules:
            m = re.fullmatch(pattern, path)
            if m:
                arr = np.asarray(leaf, dtype=np.float32)
                state[template.format(*m.groups())] = torch.tensor(arr.T if transpose else arr)
                break
        else:
            raise KeyError(f"flax parameter {path!r} has no counterpart in the port")
    return state


def state_dict_from_flax_checkpoint(npz_path: str) -> dict[str, torch.Tensor]:
    """Return a ``state_dict`` for ``ConanModel`` or an aux head from a parameter
    checkpoint of the JAX package's ``RunCheckpointer`` (its ``best.npz`` or
    ``last.npz``), whose entries are keyed by their path in the flax tree,
    e.g. ``['params']['backbone']['blocks_0']['filter_w1']``."""
    tree: dict = {}
    with np.load(npz_path, allow_pickle=False) as data:
        for key in data.files:
            parts = re.findall(r"\['([^']*)'\]", key)
            if not parts or "".join(f"['{p}']" for p in parts) != key:
                raise KeyError(f"{npz_path}: entry {key!r} is not a flax parameter path")
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[key]
    return params_from_flax(tree)
