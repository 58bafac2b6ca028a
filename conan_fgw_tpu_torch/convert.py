"""Map a flax ``ConanModel`` parameter tree onto the port's ``state_dict``.

``params_from_flax`` takes the flax tree as nested dicts of numpy arrays
(with or without the top-level ``"params"`` key). Flax ``Dense`` kernels are
``(in, out)`` and become torch ``Linear`` weights ``(out, in)``; embedding
tables, the raw cfconv filter parameters and the GAT attention vectors are
copied as they are. A leaf that no rule maps raises.
``state_dict_from_flax_checkpoint`` does the same for a parameter
checkpoint file of the JAX package, reading it with numpy alone.
"""

from __future__ import annotations

import re

import numpy as np
import torch

# (flax path regex, torch name template, transpose)
_RULES = (
    (r"backbone/embedding/embedding", "backbone.embedding.weight", False),
    (r"backbone/blocks_(\d+)/(filter_[wb][12])", "backbone.blocks.{0}.{1}", False),
    (r"backbone/blocks_(\d+)/Dense_0/kernel", "backbone.blocks.{0}.lin1.weight", True),
    (r"backbone/blocks_(\d+)/Dense_1/kernel", "backbone.blocks.{0}.lin2.weight", True),
    (r"backbone/blocks_(\d+)/Dense_1/bias", "backbone.blocks.{0}.lin2.bias", False),
    (r"backbone/blocks_(\d+)/Dense_2/kernel", "backbone.blocks.{0}.lin.weight", True),
    (r"backbone/blocks_(\d+)/Dense_2/bias", "backbone.blocks.{0}.lin.bias", False),
    (r"backbone/(lin[12](?:_bary)?)/kernel", "backbone.{0}.weight", True),
    (r"backbone/(lin[12](?:_bary)?)/bias", "backbone.{0}.bias", False),
    (r"gat/DenseGATConv_(\d+)/Dense_0/kernel", "gat.convs.{0}.lin.weight", True),
    (r"gat/DenseGATConv_(\d+)/Dense_1/kernel", "gat.convs.{0}.lin_edge.weight", True),
    (r"gat/DenseGATConv_(\d+)/(att_src|att_dst|att_edge|bias)", "gat.convs.{0}.{1}", False),
    (r"(t3d|tcov|tbary)/kernel", "{0}.weight", True),
    (r"(t3d|tcov|tbary)/bias", "{0}.bias", False),
    (r"head/Dense_0/kernel", "head.weight", True),
    (r"head/Dense_0/bias", "head.bias", False),
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
    state = {}
    for path, leaf in _flatten(tree):
        for pattern, template, transpose in _RULES:
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
