"""mfu_pct: the model FLOPs of one unit of work (a batch, or a step),
counted over the plain reference (``portbench/reference/work.py``), over
the window's host-clock time per unit, over the fp32 peak of one H100 (67
TFLOP/s). One reader for every cell: ``mfu_pct.serve`` and ``.train``."""

from portbench.readers import mfu_pct


def read(run):
    return mfu_pct(run)
