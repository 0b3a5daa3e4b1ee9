"""decoder_device_ms.dac: device ms per batch launched inside the program's
``decoder.*`` spans in the DAC (the first conv, each ``DecoderBlock``, the
last snake, conv and tanh, ``esc_tpu_torch/baselines/dac/model.py::
Decoder``), in the traced batches."""

from portbench.spans import device_ms


def read(run):
    return device_ms(run, "decoder.*")
