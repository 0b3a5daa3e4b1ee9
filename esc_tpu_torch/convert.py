"""Weights carrier: JAX (flax) parameters <-> the port's state dict.

Port of the key mapping of ``esc_tpu/convert.py`` (``flax_to_torch``,
``_flax_path_to_torch_key``, ``torch_to_flax``) for the ESC modules and the
discriminator. The input is the flax parameter tree as nested dicts of
array-likes (numpy arrays, e.g. after ``jax.tree.map(np.asarray,
variables)``), with or without the top-level ``"params"`` collection. No
JAX is imported.

    encoder/blocks_0/swint_blocks_1/attn/qkv/kernel
        -> encoder.blocks.0.swint_blocks.1.attn.qkv.weight  (transposed)
    quantizers_2/vqs_1/embedding -> quantizers.2.vqs.1.embedding.weight
    patch_embed/proj/kernel      -> patch_embed.proj.weight (HWIO -> OIHW)
    .../norm/scale               -> .../norm.weight

The convolution backbone's layers (``esc_tpu/modules/convolution.py``)
keep their flax names, list entries included; its BatchNorm statistics,
flax's ``batch_stats`` collection, are the modules' running buffers:

    encoder/blocks_0/blocks_0/block_0/conv/kernel
        -> encoder.blocks.0.blocks.0.block.0.conv.weight  (HWIO -> OIHW)
    decoder/blocks_0/blocks_1/conv/kernel   (a ConvTranspose, HWOI)
        -> decoder.blocks.0.blocks.1.conv.weight          (IOHW)
    .../block_1/scale, .../block_2/weight (BatchNorm, PReLU)
        -> .../block.1.weight, .../block.2.weight
    batch_stats: .../block_1/mean, var -> .../block.1.running_mean, _var

The DAC baseline (``esc_tpu/baselines/dac``) wraps each convolution as
``nn.WeightNorm(nn.Conv(...), name="conv")`` inside a module of its own
name, and its lists are ``block_N`` / ``model_N`` / ``quantizers_N``:

    encoder/block_1/block_0/block_1/Conv_0/kernel   (WIO)
        -> encoder.block.1.block.0.block.1.weight_v   (OIW)
    encoder/block_1/block_0/block_1/conv/Conv_0/kernel/scale
        -> encoder.block.1.block.0.block.1.weight_g   ((out,) -> (out, 1, 1))
    decoder/model_1/block_1/ConvTranspose_0/kernel  (WOI)
        -> decoder.model.1.block.1.weight_v           (IOW)
    encoder/block_5/alpha (1, 1, C)  -> encoder.block.5.alpha (1, C, 1)
    quantizer/quantizers_0/codebook  -> quantizer.quantizers.0.codebook.weight

These are the keys of the reference's ``torch.nn.utils.weight_norm``
state dicts (a transposed convolution's ``weight_g`` is per input channel,
as flax's scale over its kernel's last axis).

A flax ``ConvTranspose(transpose_kernel=True)`` kernel is HWOI, and torch's
``ConvTranspose2d`` weight IOHW, so the one permutation of conv kernels
carries both (``esc_tpu/convert.py:12-19``).

Weight-normalised convolutions (flax ``nn.WeightNorm`` around ``nn.Conv``,
``esc_tpu/convert.py:43-110``) map onto the port's direction and magnitude
(:class:`esc_tpu_torch.models.discriminator.WNConv`):

    discriminators_5/band_convs_0_1/Conv_0/kernel
        -> discriminators.5.band_convs.0.1.weight_v  (HWIO -> OIHW, WIO -> OIW)
    discriminators_5/band_convs_0_1/Conv_0/bias
        -> discriminators.5.band_convs.0.1.bias
    discriminators_5/band_convs_0_1/wn/Conv_0/kernel/scale
        -> discriminators.5.band_convs.0.1.weight_g  ((out,) -> (out, 1, 1, 1))

:func:`to_jax_params` is the inverse, from the port's module: what the
port trains is saved in the layout the JAX package loads.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch
import torch.nn as nn

__all__ = ["from_jax_params", "to_jax_params", "to_jax_variables",
           "flax_path_to_key"]

_LIST_COMPONENT = re.compile(r"^(.*)_(\d+)$")
# flax submodule names that are list entries in the torch module tree
_LIST_NAMES = {"blocks", "swint_blocks", "quantizers", "vqs", "down_projs",
               "up_projs", "discriminators", "convs", "band_convs", "block",
               "model"}
_LEAF_NAMES = {"kernel": "weight", "scale": "weight", "bias": "bias",
               "weight": "weight",                          # PReLU's slope
               "embedding": "embedding.weight",
               "codebook": "codebook.weight", "alpha": "alpha",  # the DAC's
               "relative_position_bias_table": "relative_position_bias_table",
               "mean": "running_mean", "var": "running_var"}  # batch_stats
_STATS = {"running_mean": "mean", "running_var": "var"}
_WN_INNER = "Conv_0"                  # nn.WeightNorm's wrapped nn.Conv
# the names of nn.WeightNorm wrappers, and of the layers they wrap (a
# wrapper's scale is one flax key, "<layer>/kernel/scale")
_WN_WRAPPERS = ("wn", "conv")
_WN_LAYERS = ("Conv_0", "ConvTranspose_0")


def _split_list_name(name: str):
    """``'band_convs_0_1'`` -> ``['band_convs', '0', '1']`` where the base
    is a list of modules in the port; other names stay whole."""
    idxs, base = [], name
    while (m := _LIST_COMPONENT.match(base)):
        base = m.group(1)
        idxs.insert(0, m.group(2))
    return [base] + idxs if idxs and base in _LIST_NAMES else [name]


def flax_path_to_key(path) -> str:
    """``('encoder', 'blocks_0', 'attn', 'qkv', 'kernel')`` ->
    ``'encoder.blocks.0.attn.qkv.weight'``; weight-normalised convolutions
    as in the module docstring."""
    *mods, leaf = path
    if mods and mods[-1] in _WN_WRAPPERS and leaf in (
            f"{layer}/kernel/scale" for layer in _WN_LAYERS):
        mods, name = mods[:-1], "weight_g"
    elif mods and mods[-1] in _WN_LAYERS and leaf in ("kernel", "bias"):
        mods, name = mods[:-1], "weight_v" if leaf == "kernel" else "bias"
    elif leaf in _LEAF_NAMES:
        name = _LEAF_NAMES[leaf]
    else:
        raise KeyError(f"no torch name for flax leaf {'/'.join(path)}")
    parts = [p for m in mods for p in _split_list_name(m)]
    return ".".join(parts + [name])


def _walk(tree: Mapping[str, Any], prefix=()):
    for name, value in tree.items():
        if isinstance(value, Mapping):
            yield from _walk(value, prefix + (name,))
        else:
            yield prefix + (name,), value


_TO_TORCH = {2: (1, 0), 3: (2, 1, 0), 4: (3, 2, 0, 1)}   # flax -> torch
_TO_FLAX = {2: (1, 0), 3: (2, 1, 0), 4: (2, 3, 1, 0)}    # torch -> flax


def from_jax_params(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax parameters -> torch-key state dict of float32 tensors.

    ``params`` is the parameter tree, or flax variables ``{"params": ...,
    "batch_stats": ...}``, whose statistics become BatchNorm buffers.
    Dense kernels ``(in, out)`` become Linear weights ``(out, in)``; conv
    kernels HWIO / WIO become OIHW / OIW; LayerNorm ``scale`` becomes
    ``weight``; a WeightNorm scale ``(out,)`` takes its kernel's rank.
    """
    stats: Mapping[str, Any] = {}
    if "params" in params and isinstance(params["params"], Mapping):
        stats = params.get("batch_stats") or {}
        params = params["params"]
    out: Dict[str, np.ndarray] = {}
    for path, leaf in list(_walk(params)) + list(_walk(stats)):
        v = np.asarray(leaf, dtype=np.float32)
        if path[-1] == "kernel" and v.ndim in _TO_TORCH:
            v = v.transpose(_TO_TORCH[v.ndim])
        elif path[-1] == "alpha":               # snake (1, 1, C) -> NCW
            v = v.reshape(1, -1, 1)
        out[flax_path_to_key(path)] = v
    for key, v in out.items():
        if key.endswith(".weight_g"):
            rank = out[key[:-1] + "v"].ndim
            out[key] = v.reshape((-1,) + (1,) * (rank - 1))
    return {k: torch.tensor(np.ascontiguousarray(v)) for k, v in out.items()}


def _flax_parts(name: str):
    """A torch module path -> its flax module names: ``blocks.0`` ->
    ``blocks_0``, for the lists of :data:`_LIST_NAMES`."""
    parts = []
    for part in name.split(".") if name else []:
        if part.isdigit() and parts and \
                _split_list_name(parts[-1] + "_0")[0] in _LIST_NAMES:
            parts[-1] = f"{parts[-1]}_{part}"
        else:
            parts.append(part)
    return parts


def _put(tree: Dict[str, Any], parts, leaf: str, v: np.ndarray) -> None:
    node = tree
    for part in parts:
        node = node.setdefault(part, {})
    node[leaf] = np.ascontiguousarray(v)


def to_jax_variables(module: nn.Module) -> Dict[str, Any]:
    """The port's module -> flax variables: ``{"params": ...}``
    (:func:`to_jax_params`) and, where the module has BatchNorm layers,
    ``"batch_stats"`` with their running means and variances."""
    stats: Dict[str, Any] = {}
    for name, sub in module.named_modules():
        if isinstance(sub, nn.modules.batchnorm._BatchNorm):
            for buf, leaf in _STATS.items():
                _put(stats, _flax_parts(name), leaf,
                     getattr(sub, buf).detach().cpu().float().numpy())
    variables = {"params": to_jax_params(module)}
    if stats:
        variables["batch_stats"] = stats
    return variables


def to_jax_params(module: nn.Module) -> Dict[str, Any]:
    """The port's module -> flax parameter tree (nested dicts of float32
    numpy arrays), the inverse of :func:`from_jax_params`: Linear weights
    become Dense kernels ``(in, out)``, conv weights HWIO / WIO kernels
    (transposed convs' IOHW weights HWOI ones), LayerNorm and BatchNorm
    weights ``scale``, PReLU slopes stay ``weight``, weight-normalised
    convolutions ``Conv_0/kernel``, ``Conv_0/bias`` and
    ``wn/Conv_0/kernel/scale`` (the DAC's under the names its layers give,
    ``flax_names``), snake alphas ``(1, 1, C)``."""
    tree: Dict[str, Any] = {}
    for name, sub in module.named_modules():
        weight_norm = "weight_v" in sub._parameters
        wrapper, layer = getattr(sub, "flax_names", ("wn", _WN_INNER))
        for leaf, p in sub.named_parameters(recurse=False):
            v = p.detach().cpu().float().numpy()
            mods = name.split(".") if name else []
            if weight_norm:
                if leaf == "weight_g":
                    mods, leaf, v = (mods + [wrapper], f"{layer}/kernel/scale",
                                     v.reshape(-1))
                else:
                    mods = mods + [layer]
                    if leaf == "weight_v":
                        leaf, v = "kernel", v.transpose(_TO_FLAX[v.ndim])
            elif isinstance(sub, nn.Embedding):
                # .../vqs_m/embedding, or the DAC's .../quantizers_m/codebook
                mods, leaf = mods[:-1], mods[-1]
            elif leaf == "alpha":                   # snake (1, C, 1)
                v = v.reshape(1, 1, -1)
            elif leaf == "weight" and isinstance(
                    sub, (nn.LayerNorm, nn.modules.batchnorm._BatchNorm)):
                leaf = "scale"
            elif leaf == "weight" and v.ndim > 1:
                leaf, v = "kernel", v.transpose(_TO_FLAX[v.ndim])
            _put(tree, _flax_parts(".".join(mods)), leaf, v)
    return tree
