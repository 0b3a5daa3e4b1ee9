"""Weights from a seed, in the reference's key layout, made on the device.

One normal draw of all the values a module needs, from a
``torch.Generator`` on the device, then scaled in place leaf by leaf as
views of that one draw (so the same seed gives the same weights on any run
of one device type):

- Linear, Conv and weight-normalised directions (``weight``,
  ``weight_v``): a unit normal over the square root of the fan-in;
- LayerNorm scales 1, every bias and ``weight_g`` as below;
- weight-norm magnitudes (``weight_g``) 1, so each output channel's kernel
  starts at unit norm;
- relative position tables: 0.02 times a normal, clamped at 0.04;
- codebooks: Kaiming-normal, a normal times ``sqrt(2 / dim)``.

These are the benchmark's own choices, not a published checkpoint's: the
speed of a step does not depend on the values, and both the program and
the reference are handed the same ones.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

__all__ = ["fill", "seeded_generator"]


def seeded_generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=torch.device(device)).manual_seed(
        int(seed) % (2 ** 63))


@torch.no_grad()
def fill(module: nn.Module, gen: torch.Generator) -> None:
    """Overwrite every parameter of ``module`` from ``gen`` (see the
    module docstring). The module sits on the generator's device."""
    kinds = {}
    for mod_name, mod in module.named_modules():
        for p_name, _ in mod.named_parameters(recurse=False):
            kinds[f"{mod_name}.{p_name}".lstrip(".")] = type(mod)
    params = list(module.named_parameters())
    total = sum(p.numel() for _, p in params)
    dev = params[0][1].device
    flat = torch.randn(total, generator=gen, device=dev)
    off = 0
    for name, p in params:
        draw = flat[off:off + p.numel()].view_as(p)
        off += p.numel()
        leaf, kind = name.rsplit(".", 1)[-1], kinds[name]
        if leaf == "bias":
            p.zero_()
        elif kind is nn.LayerNorm:
            p.fill_(1.0)
        elif leaf == "weight_g":
            p.fill_(1.0)
        elif leaf == "relative_position_bias_table":
            p.copy_((0.02 * draw).clamp(-0.04, 0.04))
        elif kind is nn.Embedding:
            p.copy_(draw * math.sqrt(2.0 / p.shape[1]))
        else:
            p.copy_(draw / math.sqrt(p[0].numel()))
