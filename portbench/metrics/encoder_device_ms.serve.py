"""encoder_device_ms.serve: device ms per batch launched inside the
program's ``encoder.*`` spans (patch embedding and each down-scaling Swin
layer, ``esc_tpu_torch/models/base.py::Encoder``), in the traced
batches."""

from portbench.spans import device_ms


def read(run):
    return device_ms(run, "encoder.*")
