"""vq_device_ms.serve: device ms per batch launched inside the program's
``vq.*`` spans (each scale's product VQ with its residual: the codebook
argmin, the gathers, ``esc_tpu_torch/models/csrvq.py``), in encode and
decode, in the traced batches."""

from portbench.spans import device_ms


def read(run):
    return device_ms(run, "vq.*")
