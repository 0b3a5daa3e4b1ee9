"""encoder_device_ms.encodec: device ms per batch launched inside the
program's ``encoder.*`` spans in EnCodec (the first conv, the residual
unit, ELU and strided conv of each ratio, the 2-layer SLSTM, the last ELU
and conv; ``esc_tpu_torch/baselines/encodec/model.py::SEANetEncoder``), in
the traced batches."""

from portbench.spans import device_ms


def read(run):
    if "Encodec" not in run.config:
        return None
    return device_ms(run, "encoder.*")
