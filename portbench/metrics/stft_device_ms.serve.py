"""stft_device_ms.serve: device ms per batch launched inside the program's
spans ``codec.stft`` and ``codec.istft`` (the STFT into the encoder and the
ISTFT out of the decoder, ``esc_tpu_torch/models/codecs.py``), in the traced
batches."""

from portbench.spans import device_ms


def read(run):
    return device_ms(run, "codec.stft", "codec.istft")
