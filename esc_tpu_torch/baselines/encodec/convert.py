"""EnCodec's weights carrier: the JAX package's flax tree <-> the port's
state dict (the release's keys), both ways, and the release-file loader.

Port of ``esc_tpu/baselines/encodec/convert.py``. flax's ``WeightNorm``
keeps direction and magnitude apart, as the release does, so nothing is
folded; each leaf is a transpose or a reshape:

  flax, in {encoder,decoder}/layer_{n}   port and release, <side>.model.{n}
  ------------------------------------  ----------------------------------
  Conv_0/kernel          (K, I, O)      conv.conv.weight_v       (O, I, K)
  ConvTranspose_0/kernel (K, O, I)      convtr.convtr.weight_v   (I, O, K)
  conv/<inner>/kernel/scale             <inner>.weight_g   (O or I, 1, 1)
  block_{j}/...                         block.{2j + 1}...  (ELUs between)
  shortcut/...                          shortcut...
  lstm_{k}/wi, wh        (C, 4H)        lstm.weight_{ih,hh}_l{k}  (4H, C)
  lstm_{k}/bi, bh                       lstm.bias_{ih,hh}_l{k}
  quantizer/codebooks[q]                quantizer.vq.layers.{q}._codebook.embed

The ELUs hold their slots in both trees' numbering (``model.py:75``).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

__all__ = ["from_jax_params", "to_jax_params", "load_release",
           "EMA_BUFFERS"]

# the release's k-means EMA state, which the port does not train with
EMA_BUFFERS = ("_codebook.inited", "_codebook.cluster_size",
               "_codebook.embed_avg")
_INNER = {"Conv_0": "conv", "ConvTranspose_0": "convtr"}
_LSTM = {"wi": "weight_ih_l", "wh": "weight_hh_l", "bi": "bias_ih_l",
         "bh": "bias_hh_l"}
_LSTM_FLAX = {v: k for k, v in _LSTM.items()}
_KEY = re.compile(r"^(encoder|decoder)\.model\.(\d+)\.(.+)$")


def _index(name: str) -> int:
    return int(name.rsplit("_", 1)[1])


def _conv_from(out: Dict[str, np.ndarray], prefix: str,
               layer: Mapping[str, Any]) -> None:
    flax_inner = "ConvTranspose_0" if "ConvTranspose_0" in layer \
        else "Conv_0"
    inner = _INNER[flax_inner]
    key = f"{prefix}.{inner}.{inner}"
    out[f"{key}.weight_v"] = np.asarray(
        layer[flax_inner]["kernel"]).transpose(2, 1, 0)
    out[f"{key}.bias"] = np.asarray(layer[flax_inner]["bias"])
    out[f"{key}.weight_g"] = np.asarray(
        layer["conv"][f"{flax_inner}/kernel/scale"]).reshape(-1, 1, 1)


def from_jax_params(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The flax parameter tree of ``esc_tpu``'s ``EncodecModule`` (or its
    variables ``{"params": ...}``) -> the port's state dict."""
    params = params.get("params", params)
    out: Dict[str, np.ndarray] = {}
    for side in ("encoder", "decoder"):
        for name, layer in params[side].items():
            prefix = f"{side}.model.{_index(name)}"
            if "lstm_0" in layer:
                for cell_name, cell in layer.items():
                    k = _index(cell_name)
                    for leaf, key in _LSTM.items():
                        v = np.asarray(cell[leaf])
                        out[f"{prefix}.lstm.{key}{k}"] = \
                            v.T if v.ndim == 2 else v
            elif "Conv_0" in layer or "ConvTranspose_0" in layer:
                _conv_from(out, prefix, layer)
            else:                                     # a residual unit
                for sub_name, sub in layer.items():
                    sub_key = "shortcut" if sub_name == "shortcut" \
                        else f"block.{2 * _index(sub_name) + 1}"
                    _conv_from(out, f"{prefix}.{sub_key}", sub)
    for q, table in enumerate(np.asarray(params["quantizer"]["codebooks"])):
        out[f"quantizer.vq.layers.{q}._codebook.embed"] = table
    return {k: torch.tensor(np.ascontiguousarray(v, np.float32))
            for k, v in out.items()}


def _put(tree: Dict[str, Any], path, v: np.ndarray) -> None:
    for part in path[:-1]:
        tree = tree.setdefault(part, {})
    tree[path[-1]] = np.ascontiguousarray(v)


def to_jax_params(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's (or the release's) state dict -> the flax parameter tree
    that ``esc_tpu``'s ``EncodecModule`` applies; the inverse of
    :func:`from_jax_params`."""
    tree: Dict[str, Any] = {}
    codebooks = {}
    for key, t in state_dict.items():
        v = t.detach().cpu().float().numpy() if isinstance(
            t, torch.Tensor) else np.asarray(t, np.float32)
        if key.startswith("quantizer."):
            codebooks[int(key.split(".")[3])] = v
            continue
        side, n, rest = _KEY.match(key).groups()
        path = [side, f"layer_{n}"]
        parts = rest.split(".")
        if parts[0] == "lstm":
            leaf, k = re.match(r"^(.+_l)(\d+)$", parts[1]).groups()
            _put(tree, path + [f"lstm_{k}", _LSTM_FLAX[leaf]],
                 v.T if v.ndim == 2 else v)
            continue
        if parts[0] == "block":
            path.append(f"block_{(int(parts[1]) - 1) // 2}")
            parts = parts[2:]
        elif parts[0] == "shortcut":
            path.append("shortcut")
            parts = parts[1:]
        inner, leaf = parts[0], parts[-1]
        flax_inner = "ConvTranspose_0" if inner == "convtr" else "Conv_0"
        if leaf == "weight_v":
            _put(tree, path + [flax_inner, "kernel"], v.transpose(2, 1, 0))
        elif leaf == "bias":
            _put(tree, path + [flax_inner, "bias"], v)
        else:
            _put(tree, path + ["conv", f"{flax_inner}/kernel/scale"],
                 v.reshape(-1))
    tree["quantizer"] = {"codebooks": np.stack(
        [codebooks[q] for q in range(len(codebooks))])}
    return tree


def load_release(path: str) -> Dict[str, torch.Tensor]:
    """A released ``encodec_24khz`` file: a state dict, or ``{"best_state":
    state dict}``, less the codebooks' EMA buffers (``convert.py:115-
    121``)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "best_state" in sd:
        sd = sd["best_state"]
    return {k: v for k, v in sd.items() if not k.endswith(EMA_BUFFERS)}
