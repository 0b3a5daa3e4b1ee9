"""codebook_argmin_roofline.dac: the least time the card needs for the DAC's
argmin calls of the traced batches (``esc_tpu_torch/csrc/
codebook_argmin.cu``, shared with ESC), over the device time of the kernels
whose name holds ``codebook_argmin``. The calls are counted here from the
configuration and the traffic: one search a stage, of every frame of
every clip of the batch, in the stage's codebook (``reference/work.py::
argmin_work`` gives each call's bytes and operations)."""

from portbench.readers import roofline_pct
from portbench.reference.work import argmin_work

KERNELS = ("codebook_argmin",)


def argmin_calls(cfg: dict, batch: int, length: int) -> list:
    """``(N, K, d)`` of every argmin call of one ``DAC.encode_codes`` of
    ``batch`` clips of ``length`` samples: every stage searches, whatever
    number of them is sent, one row a frame of a hop (``decode_codes``
    searches nothing)."""
    hop = 1
    for s in cfg["encoder_rates"]:
        hop *= s
    rows = batch * -(-length // hop)
    return [(rows, cfg["codebook_size"], cfg["codebook_dim"])] \
        * cfg["n_codebooks"]


def calls(config, traffic):
    return [argmin_work(*c) for c in argmin_calls(
        config["DAC"], traffic["batch"], traffic["length"])]


def read(run):
    if "DAC" not in run.config:
        return None
    return roofline_pct(run, KERNELS, calls)
