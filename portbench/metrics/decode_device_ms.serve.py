"""decode_device_ms.serve: device ms per batch launched inside the benchmark's
span around the codec instance's ``decode`` (``ESC.decode``,
``esc_tpu_torch/models/codecs.py``), in the traced batches."""

from portbench.readers import span_ms


def read(run):
    return span_ms(run, "esc.decode")
