"""encoder_device_ms.dac: device ms per batch launched inside the program's
``encoder.*`` spans in the DAC (the first conv, each ``EncoderBlock``, the
last snake and conv, ``esc_tpu_torch/baselines/dac/model.py::Encoder``), in
the traced batches."""

from portbench.spans import device_ms


def read(run):
    return device_ms(run, "encoder.*")
