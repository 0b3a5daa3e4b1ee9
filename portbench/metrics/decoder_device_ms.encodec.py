"""decoder_device_ms.encodec: device ms per batch launched inside the
program's ``decoder.*`` spans in EnCodec (the first conv, the 2-layer
SLSTM, the ELU, strided transposed conv and residual unit of each ratio,
the last ELU and conv; ``esc_tpu_torch/baselines/encodec/model.py::
SEANetDecoder``), in the traced batches."""

from portbench.spans import device_ms


def read(run):
    if "Encodec" not in run.config:
        return None
    return device_ms(run, "decoder.*")
