"""The evaluation sweep (port of ``esc_tpu/train/evaluate.py``; reference:
scripts/test.py:22-55).

The audio goes to the model's device once per batch; the codec's output
stays there for Mel distance, SI-SDR and the code histogram, and only the
per-utterance scores come back to the host (PESQ and STOI take the audio
to the host themselves).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..metrics import EntropyCounter

__all__ = ["eval_epoch"]


def _mean(v) -> float:
    """NaN-skipping mean; NaN where no value is finite (PESQ rejects)."""
    v = np.asarray(v, dtype=np.float64)
    return float(np.nanmean(v)) if np.isfinite(v).any() else float("nan")


def eval_epoch(model, eval_loader, metric_funcs: Dict,
               e_counter: EntropyCounter, bps_per_stream: float = 1.5,
               num_streams: Optional[int] = None,
               verbose: bool = True) -> Dict[str, list]:
    """Score ``model`` (an :class:`esc_tpu_torch.models.Codec`) over
    ``eval_loader``: ``{metric: [mean per bitrate], "utilization": [...]}``,
    the reference's ``all_perf`` layout. ``num_streams=None`` sweeps
    1..max_streams (1.5 to 9 kbps)."""
    spc = model._samples_per_code()
    all_perf = {k: [] for k in metric_funcs}
    all_perf["utilization"] = []
    streams = (range(num_streams, num_streams + 1) if num_streams is not None
               else range(1, model.max_streams + 1))
    for s in streams:
        perf = {k: [] for k in metric_funcs}
        e_counter.reset_stats(num_streams=s)
        for batch in eval_loader:
            x, lengths = batch if isinstance(batch, tuple) else (batch, None)
            x = torch.as_tensor(x).to(model.device)
            out = model(x, num_streams=s)
            recon, codes = out["recon_audio"], out["codes"]
            if lengths is not None:
                keep = lengths > 0  # the padding rows of a short last batch
                for k, fn in metric_funcs.items():
                    perf[k].extend(np.asarray(fn(x, recon, lengths))[keep]
                                   .tolist())
                e_counter.update(codes[torch.from_numpy(keep).to(
                    codes.device)], lengths=lengths[keep],
                    samples_per_code=spc)
            else:
                for k, fn in metric_funcs.items():
                    perf[k].extend(np.asarray(fn(x, recon)).tolist())
                e_counter.update(codes)
        for k, v in perf.items():
            all_perf[k].append(round(_mean(v), 4))
        rate, _ = e_counter.compute_utilization()
        all_perf["utilization"].append(rate)
        if verbose:
            print(f"Test Metrics at {s * bps_per_stream:.2f}kbps: ", end="")
            print(" | ".join(f"{k}: {_mean(v):.4f}" for k, v in perf.items()),
                  f"| utilization: {rate:.4f}")
    return all_perf
