"""decoder_device_ms.serve: device ms per batch launched inside the
program's ``decoder.*`` spans (each up-scaling Swin layer, then the top
layer and patch de-embedding, ``esc_tpu_torch/models/base.py::Decoder``),
in encode, which runs the decoder's layers between its scales, and in
decode, in the traced batches."""

from portbench.spans import device_ms


def read(run):
    return device_ms(run, "decoder.*")
