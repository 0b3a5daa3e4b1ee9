"""Weights carrier: JAX (flax) parameters <-> the port's state dict.

Port of the key mapping of ``esc_tpu/convert.py`` (``flax_to_torch``,
``_flax_path_to_torch_key``, ``torch_to_flax``) for the ESC modules. The
input is the flax parameter tree as nested dicts of array-likes (numpy
arrays, e.g. after ``jax.tree.map(np.asarray, variables)``), with or
without the top-level ``"params"`` collection. No JAX is imported.

    encoder/blocks_0/swint_blocks_1/attn/qkv/kernel
        -> encoder.blocks.0.swint_blocks.1.attn.qkv.weight  (transposed)
    quantizers_2/vqs_1/embedding -> quantizers.2.vqs.1.embedding.weight
    patch_embed/proj/kernel      -> patch_embed.proj.weight (HWIO -> OIHW)
    .../norm/scale               -> .../norm.weight

:func:`to_jax_params` is the inverse, from the port's module: what the
port trains is saved in the layout the JAX package loads.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch
import torch.nn as nn

__all__ = ["from_jax_params", "to_jax_params", "flax_path_to_key"]

_LIST_COMPONENT = re.compile(r"^(.*)_(\d+)$")
# flax submodule names that are list entries in the torch module tree
_LIST_NAMES = {"blocks", "swint_blocks", "quantizers", "vqs", "down_projs",
               "up_projs"}
_LEAF_NAMES = {"kernel": "weight", "scale": "weight", "bias": "bias",
               "embedding": "embedding.weight",
               "relative_position_bias_table": "relative_position_bias_table"}


def flax_path_to_key(path) -> str:
    """``('encoder', 'blocks_0', 'attn', 'qkv', 'kernel')`` ->
    ``'encoder.blocks.0.attn.qkv.weight'``."""
    parts = []
    for name in path[:-1]:
        m = _LIST_COMPONENT.match(name)
        if m and m.group(1) in _LIST_NAMES:
            parts.extend(m.groups())
        else:
            parts.append(name)
    leaf = path[-1]
    if leaf not in _LEAF_NAMES:
        raise KeyError(f"no torch name for flax leaf {'/'.join(path)}")
    parts.append(_LEAF_NAMES[leaf])
    return ".".join(parts)


def _walk(tree: Mapping[str, Any], prefix=()):
    for name, value in tree.items():
        if isinstance(value, Mapping):
            yield from _walk(value, prefix + (name,))
        else:
            yield prefix + (name,), value


def from_jax_params(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ESC parameters -> torch-key state dict of float32 tensors.

    Dense kernels ``(in, out)`` become Linear weights ``(out, in)``; conv
    kernels HWIO become OIHW; LayerNorm ``scale`` becomes ``weight``.
    """
    if "params" in params and isinstance(params["params"], Mapping):
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in _walk(params):
        v = np.asarray(leaf, dtype=np.float32)
        if path[-1] == "kernel" and v.ndim == 2:
            v = v.T
        elif path[-1] == "kernel" and v.ndim == 4:
            v = v.transpose(3, 2, 0, 1)
        out[flax_path_to_key(path)] = torch.tensor(np.ascontiguousarray(v))
    return out


def to_jax_params(module: nn.Module) -> Dict[str, Any]:
    """The port's ESC module -> flax parameter tree (nested dicts of
    float32 numpy arrays), the inverse of :func:`from_jax_params`: Linear
    weights become Dense kernels ``(in, out)``, conv weights HWIO kernels,
    LayerNorm weights ``scale``."""
    tree: Dict[str, Any] = {}
    for name, sub in module.named_modules():
        for leaf, p in sub.named_parameters(recurse=False):
            v = p.detach().cpu().float().numpy()
            if isinstance(sub, nn.Embedding):
                path = name.split(".")           # .../vqs_m/embedding
            elif leaf == "weight" and isinstance(sub, nn.LayerNorm):
                path = name.split(".") + ["scale"]
            elif leaf == "weight":
                path = name.split(".") + ["kernel"]
                v = v.T if v.ndim == 2 else v.transpose(2, 3, 1, 0)
            else:
                path = name.split(".") + [leaf]
            parts = []
            for part in path:
                if part.isdigit() and parts and parts[-1] in _LIST_NAMES:
                    parts[-1] = f"{parts[-1]}_{part}"
                else:
                    parts.append(part)
            node = tree
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = np.ascontiguousarray(v)
    return tree
