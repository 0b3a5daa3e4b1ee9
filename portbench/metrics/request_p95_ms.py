"""request_p95_ms: the 95th percentile of every request of the window, each
timed on the host clock from the call with its host array to both its codes
and its waveform on the host."""

import numpy as np


def read(run):
    lat = [u["latency_s"] for u in run.units if "latency_s" in u]
    return 1e3 * float(np.percentile(lat, 95)) if lat else None
