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

Schedules compute in float32, as the JAX package's do.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

__all__ = ["GAMMA", "SCHEDULES", "make_schedule", "AdamW"]

GAMMA = 0.999996  # exponential decay per step (scripts/utils.py:51)
B1, B2, EPS, WEIGHT_DECAY = 0.9, 0.999, 1e-8, 0.01  # torch's AdamW defaults
SCHEDULES = ("constant", "constant_warmup", "cosine_warmup",
             "exponential_decay")

_f32 = np.float32


def make_schedule(scheduler_type: str, base_lr: float,
                  total_steps: int = 250000, warmup_steps: int = 0
                  ) -> Callable[[int], float]:
    """The learning rate at update count ``step`` (scripts/utils.py:52-65):
    ``constant``, ``constant_warmup`` (linear from 0 over ``warmup_steps``),
    ``cosine_warmup`` (linear warm-up, then a half cosine to 0 at
    ``total_steps``, as ``transformers.get_cosine_schedule_with_warmup``)
    or ``exponential_decay`` (``base_lr * GAMMA ** step``)."""
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
        return lambda step: float(lr * np.power(_f32(GAMMA), _f32(step),
                                                dtype=_f32))
    raise ValueError(f"{scheduler_type} must be in {SCHEDULES}")


class AdamW:
    """AdamW over named parameters, with an optional global-norm clip of
    the gradients before the step (scripts/trainer_no_adv.py:116-117).

    ``schedule`` (:func:`make_schedule`) gives the learning rate at the
    update count. The state is the count and both moments, by parameter
    name (:meth:`state_dict`); :meth:`renew` starts them again.
    """

    def __init__(self, named_params: Iterable[Tuple[str, torch.Tensor]],
                 schedule: Callable[[int], float],
                 clip_norm: Optional[float] = None):
        self.names, self.params = map(list, zip(*named_params))
        self.schedule, self.clip_norm = schedule, clip_norm
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
        bc1 = float(_f32(1) - np.power(_f32(B1), _f32(self.count),
                                       dtype=_f32))
        bc2 = float(_f32(1) - np.power(_f32(B2), _f32(self.count),
                                       dtype=_f32))
        torch._foreach_mul_(self.mu, B1)
        torch._foreach_add_(self.mu, torch._foreach_mul(grads, 1 - B1))
        torch._foreach_mul_(self.nu, B2)
        torch._foreach_add_(self.nu, torch._foreach_mul(
            torch._foreach_mul(grads, grads), 1 - B2))
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

    def state_dict(self) -> Dict:
        return {"count": self.count,
                "mu": {n: m.detach().cpu().numpy()
                       for n, m in zip(self.names, self.mu)},
                "nu": {n: v.detach().cpu().numpy()
                       for n, v in zip(self.names, self.nu)}}

    def load_state_dict(self, state: Dict) -> None:
        if set(state["mu"]) != set(self.names) or \
                set(state["nu"]) != set(self.names):
            raise KeyError("optimizer state does not hold these parameters")
        self.count = int(state["count"])
        for i, n in enumerate(self.names):
            self.mu[i] = torch.as_tensor(np.array(state["mu"][n]),
                                         device=self.params[i].device)
            self.nu[i] = torch.as_tensor(np.array(state["nu"][n]),
                                         device=self.params[i].device)
