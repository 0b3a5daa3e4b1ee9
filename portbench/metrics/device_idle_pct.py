"""device_idle_pct: the share of the traced units' time in which no
kernel, copy or fill ran on the card, from the profiler's trace alone:
idle seconds inside the drivers' unit spans (a request, a step, or the
pipelined stream of batches), operation intervals merged, over the spans'
seconds (``portbench/readers.py::idle_pct``). One reader for every cell:
``device_idle_pct.serve``, ``.request`` and ``.train``."""

from portbench.readers import idle_pct


def read(run):
    return idle_pct(run)
