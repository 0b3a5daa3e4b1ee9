"""AdamW with a global-norm clip, and the learning-rate schedules.

Port of ``esc_tpu/train/optim.py`` (reference: scripts/utils.py:48-65),
which is optax's ``chain(clip_by_global_norm, adamw)``; the port follows
optax's arithmetic where it differs from ``torch.optim``:

- the clip scales by ``max / norm`` only where ``norm >= max``
  (``torch.nn.utils.clip_grad_norm_`` divides by ``norm + 1e-6``);
- the update is ``-lr * (m̂ / (sqrt(v̂) + eps) + wd * p)`` with
  betas (0.9, 0.999), eps 1e-8 and weight decay 0.01 on every parameter;
- the schedule is read at the update count before the step, and the count
  starts again at 0 when the optimizer is renewed.

Its state is optax's for that chain, as ``esc_tpu``'s checkpoints hold it:
a moment for every parameter (optax's cover the whole parameter tree,
frozen codebooks included), under the names of the flax parameter tree, so
that either package resumes from the other's ``.ckpt``.

Schedules compute in float32, as the JAX package's do.
"""

from __future__ import annotations

import math
from typing import (Any, Callable, Dict, Iterable, Mapping, Optional,
                    Tuple, Union)

import numpy as np
import torch
import torch.nn as nn

from ..convert import from_jax_params, to_jax_params

__all__ = ["GAMMA", "SCHEDULES", "make_schedule", "AdamW",
           "make_optimizer"]

GAMMA = 0.999996  # exponential decay per step (scripts/utils.py:51)
B1, B2, EPS, WEIGHT_DECAY = 0.9, 0.999, 1e-8, 0.01  # torch's AdamW defaults
SCHEDULES = ("constant", "constant_warmup", "cosine_warmup",
             "exponential_decay")

_f32 = np.float32


def make_schedule(scheduler_type: str, base_lr: float,
                  total_steps: int = 250000, warmup_steps: int = 0,
                  gamma: float = GAMMA) -> Callable[[int], float]:
    """The learning rate at update count ``step`` (scripts/utils.py:52-65):
    ``constant``, ``constant_warmup`` (linear from 0 over ``warmup_steps``),
    ``cosine_warmup`` (linear warm-up, then a half cosine to 0 at
    ``total_steps``, as ``transformers.get_cosine_schedule_with_warmup``)
    or ``exponential_decay`` (``base_lr * gamma ** step``)."""
    lr = _f32(base_lr)
    if scheduler_type == "constant":
        return lambda step: float(lr)
    if scheduler_type == "constant_warmup":
        n = max(1, warmup_steps)

        def sched(step):
            frac = _f32(1) - _f32(min(max(step, 0), n)) / _f32(n)
            return float(lr * (_f32(-1) * frac + _f32(1)))
        return sched
    if scheduler_type == "cosine_warmup":
        def sched(step):
            s = _f32(step)
            warm = min(_f32(1), s / _f32(max(1, warmup_steps))) \
                if warmup_steps > 0 else _f32(1)
            progress = np.clip((s - _f32(warmup_steps))
                               / _f32(max(1, total_steps - warmup_steps)),
                               _f32(0), _f32(1))
            cos = max(_f32(0), _f32(0.5) * (_f32(1) + np.cos(
                _f32(math.pi) * progress, dtype=_f32)))
            return float(lr * (warm if step < warmup_steps else cos))
        return sched
    if scheduler_type == "exponential_decay":
        return lambda step: float(lr * np.power(_f32(gamma), _f32(step),
                                                dtype=_f32))
    raise ValueError(f"{scheduler_type} must be in {SCHEDULES}")


class AdamW:
    """AdamW over named parameters, with an optional global-norm clip of
    the gradients before the step (scripts/trainer_no_adv.py:116-117).

    ``params`` is a module, or ``(name, tensor)`` pairs; ``learning_rate``
    a schedule (:func:`make_schedule`) read at the update count, or a
    constant, as optax takes either; ``betas`` are torch's defaults unless
    given (the DAC trainer's are (0.8, 0.99)). The state is the count and
    both moments (:meth:`state_dict`); :meth:`renew` starts them again.
    """

    def __init__(self, params: Union[nn.Module,
                                     Iterable[Tuple[str, torch.Tensor]]],
                 learning_rate: Union[float, Callable[[int], float]],
                 clip_norm: Optional[float] = None,
                 betas: Tuple[float, float] = (B1, B2)):
        self.module = params if isinstance(params, nn.Module) else None
        named = params.named_parameters() if self.module is not None \
            else params
        self.names, self.params = map(list, zip(*named))
        self.scheduled = callable(learning_rate)
        self.schedule = learning_rate if self.scheduled else (
            lambda step, lr=float(_f32(learning_rate)): lr)
        self.clip_norm = clip_norm
        self.b1, self.b2 = betas
        self.renew()

    def renew(self) -> None:
        """Zero moments and count: the schedule restarts at step 0."""
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def _clipped(self, grads):
        norm = torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(grads)))
        scale = torch.where(norm < self.clip_norm, 1.0,
                            self.clip_norm / norm)
        return torch._foreach_mul(grads, scale)

    @torch.no_grad()
    def step(self) -> None:
        """One update from the parameters' ``.grad`` (a missing one counts
        as zero). Every operation is one multi-tensor launch over all the
        parameters, and nothing waits for the device."""
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in self.params]
        if self.clip_norm is not None:
            grads = self._clipped(grads)
        lr = self.schedule(self.count)
        self.count += 1
        b1, b2 = self.b1, self.b2
        bc1 = float(_f32(1) - np.power(_f32(b1), _f32(self.count),
                                       dtype=_f32))
        bc2 = float(_f32(1) - np.power(_f32(b2), _f32(self.count),
                                       dtype=_f32))
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, torch._foreach_mul(grads, 1 - b1))
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_add_(self.nu, torch._foreach_mul(
            torch._foreach_mul(grads, grads), 1 - b2))
        denom = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, EPS)
        u = torch._foreach_div(torch._foreach_div(self.mu, bc1), denom)
        torch._foreach_add_(u, torch._foreach_mul(self.params, WEIGHT_DECAY))
        torch._foreach_mul_(u, -lr)
        torch._foreach_add_(self.params, u)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def _tree(self, tensors) -> Dict[str, Any]:
        """Tensors in the parameters' places: the module's flax parameter
        tree (:func:`esc_tpu_torch.convert.to_jax_params`), else a dict by
        name, as optax keeps a moment for a tree of parameters."""
        named = dict(zip(self.names, tensors))
        if self.module is not None:
            return to_jax_params(self.module, named)
        return {n: t.detach().cpu().numpy() for n, t in named.items()}

    def state_dict(self) -> Dict[str, Any]:
        """optax's state of ``esc_tpu``'s ``chain(clip_by_global_norm,
        adamw)`` (``esc_tpu/train/optim.py:91-94``), as
        ``flax.serialization.to_state_dict`` lays it out: ``{"0": {}, "1":
        adamw}`` with the clip, ``adamw`` alone without; ``adamw`` is
        ``{"0": {"count", "mu", "nu"}, "1": {}, "2": {"count"}}``, the last
        ``{}`` for a constant learning rate. Counts are int32."""
        count = np.asarray(self.count, np.int32)
        adamw = {"0": {"count": count, "mu": self._tree(self.mu),
                       "nu": self._tree(self.nu)},
                 "1": {}, "2": {"count": count} if self.scheduled else {}}
        return adamw if self.clip_norm is None else {"0": {}, "1": adamw}

    def load_state_dict(self, state: Mapping[str, Any]) -> None:
        """Take a :meth:`state_dict` of either package, or the port's
        earlier ``{"count", "mu", "nu"}`` by parameter name. A moment
        missing for a parameter, or held for one this optimizer lacks,
        raises a ``KeyError`` naming it."""
        if "mu" in state:
            count, mu, nu = state["count"], state["mu"], state["nu"]
        else:
            adamw = state if self.clip_norm is None else state["1"]
            adam = adamw["0"]
            count, mu, nu = adam["count"], adam["mu"], adam["nu"]
            if self.module is not None:
                mu, nu = from_jax_params(mu), from_jax_params(nu)
            if self.scheduled and int(adamw["2"]["count"]) != int(count):
                raise ValueError("the schedule's count and Adam's differ")
        for moment in (mu, nu):
            for name in set(self.names) ^ set(moment):
                raise KeyError(f"optimizer state: {name}")
        self.count = int(count)
        for i, (n, p) in enumerate(zip(self.names, self.params)):
            self.mu[i] = torch.as_tensor(np.array(mu[n]), device=p.device)
            self.nu[i] = torch.as_tensor(np.array(nu[n]), device=p.device)


def make_optimizer(params: Union[nn.Module,
                                 Iterable[Tuple[str, torch.Tensor]]],
                   lr: Union[float, Callable[[int], float]],
                   clip_norm: Optional[float] = None) -> AdamW:
    """AdamW with torch's defaults and an optional global-norm clip before
    the step, as ``esc_tpu``'s ``make_optimizer(lr, clip_norm)``
    (``esc_tpu/train/optim.py:77-96``) builds optax's chain. The
    parameters come first, as a PyTorch optimizer takes them: a module or
    ``(name, tensor)`` pairs. ``lr`` is a schedule (:func:`make_schedule`)
    or a constant."""
    return AdamW(params, lr, clip_norm=clip_norm)
