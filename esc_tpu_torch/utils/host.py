"""Device -> host transfer (port of ``esc_tpu/utils/host.py``)."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["to_host"]


def to_host(x) -> np.ndarray:
    """A numpy array of ``x``: numpy arrays pass through as they are, a
    tensor is detached and copied to the host, anything else goes through
    ``np.asarray``."""
    if isinstance(x, np.ndarray):
        return x
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
