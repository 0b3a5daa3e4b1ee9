"""codebook_argmin_roofline: the least time the card needs for the argmin
calls of the traced batches (``esc_tpu_torch/csrc/codebook_argmin.cu``),
over the device time of the kernels whose name holds ``codebook_argmin``.
The calls are the frozen count of ``portbench/reference/work.py`` at the
traffic's batch, length and streams."""

from portbench.readers import roofline_pct
from portbench.reference.work import argmin_work, main_path_calls

KERNELS = ("codebook_argmin",)


def calls(config, traffic):
    argmin, _ = main_path_calls(config["model"], traffic["batch"],
                                traffic["length"], traffic["num_streams"])
    return [argmin_work(*c) for c in argmin]


def read(run):
    if "batch" not in run.traffic:
        return None
    return roofline_pct(run, KERNELS, calls)
