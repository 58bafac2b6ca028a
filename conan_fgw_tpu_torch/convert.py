"""Map a flax ``ConanModel`` parameter tree onto the port's ``state_dict``.

``params_from_flax`` takes the flax tree as nested dicts of numpy arrays
(with or without the top-level ``"params"`` key). Flax ``Dense`` kernels are
``(in, out)`` and become torch ``Linear`` weights ``(out, in)``; embedding
tables, the raw cfconv filter parameters, the GAT attention vectors,
DimeNet's ``bilinear`` and ``bessel_freq`` and the LayerNorms' scales and
biases are copied as they are. The backbone's rules follow the tree: ViSNet's
has ``layers_0``, DimeNet's ``bessel_freq``, SchNet's neither. A
classification tree (its head has ``Dense_1``) maps ``head/Dense_i`` to
``head.lins.i`` and ``self_attention/Dense_i`` to ``self_attention.qkv.i``;
a regression tree's ``head/Dense_0`` is ``head``. A leaf that no rule maps
raises.
``state_dict_from_flax_checkpoint`` does the same for a parameter
checkpoint file of the JAX package, reading it with numpy alone.
"""

from __future__ import annotations

import re

import numpy as np
import torch

# (flax path regex, torch name template, transpose)
_SCHNET = (
    (r"backbone/blocks_(\d+)/(filter_[wb][12])", "backbone.blocks.{0}.{1}", False),
    (r"backbone/blocks_(\d+)/Dense_0/kernel", "backbone.blocks.{0}.lin1.weight", True),
    (r"backbone/blocks_(\d+)/Dense_1/kernel", "backbone.blocks.{0}.lin2.weight", True),
    (r"backbone/blocks_(\d+)/Dense_1/bias", "backbone.blocks.{0}.lin2.bias", False),
    (r"backbone/blocks_(\d+)/Dense_2/kernel", "backbone.blocks.{0}.lin.weight", True),
    (r"backbone/blocks_(\d+)/Dense_2/bias", "backbone.blocks.{0}.lin.bias", False),
    (r"backbone/(lin[12](?:_bary)?)/kernel", "backbone.{0}.weight", True),
    (r"backbone/(lin[12](?:_bary)?)/bias", "backbone.{0}.bias", False),
)
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
    (r"gat/DenseGATConv_(\d+)/Dense_0/kernel", "gat.convs.{0}.lin.weight", True),
    (r"gat/DenseGATConv_(\d+)/Dense_1/kernel", "gat.convs.{0}.lin_edge.weight", True),
    (r"gat/DenseGATConv_(\d+)/(att_src|att_dst|att_edge|bias)", "gat.convs.{0}.{1}", False),
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


def params_from_flax(flax_params) -> dict[str, torch.Tensor]:
    """Return a ``state_dict`` for ``ConanModel`` from flax parameters."""
    tree = flax_params.get("params", flax_params)
    head = _CLASSIFICATION_HEAD if "Dense_1" in tree.get("head", {}) else _REGRESSION_HEAD
    backbone = tree.get("backbone", {})
    rules = (_VISNET if "layers_0" in backbone else _DIMENET if "bessel_freq" in backbone
             else _SCHNET)
    state = {}
    for path, leaf in _flatten(tree):
        for pattern, template, transpose in _COMMON + rules + head:
            m = re.fullmatch(pattern, path)
            if m:
                arr = np.asarray(leaf, dtype=np.float32)
                state[template.format(*m.groups())] = torch.tensor(arr.T if transpose else arr)
                break
        else:
            raise KeyError(f"flax parameter {path!r} has no counterpart in the port")
    return state


def state_dict_from_flax_checkpoint(npz_path: str) -> dict[str, torch.Tensor]:
    """Return a ``state_dict`` for ``ConanModel`` from a parameter
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
