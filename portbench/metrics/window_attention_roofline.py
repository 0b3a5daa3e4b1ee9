"""window_attention_roofline: the least time the card needs for the window
attention calls of the traced batches
(``esc_tpu_torch/csrc/window_attention.cu``), over the device time of the
kernels whose name holds ``window_attention``. The calls are the frozen
count of ``portbench/reference/work.py`` at the traffic's batch, length and
streams."""

from portbench.readers import roofline_pct
from portbench.reference.work import attention_work, main_path_calls

KERNELS = ("window_attention",)


def calls(config, traffic):
    _, attn = main_path_calls(config["model"], traffic["batch"],
                              traffic["length"], traffic["num_streams"])
    return [attention_work(*c, traffic["batch"]) for c in attn]


def read(run):
    if "batch" not in run.traffic:
        return None
    return roofline_pct(run, KERNELS, calls)
