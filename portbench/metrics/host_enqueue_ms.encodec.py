"""host_enqueue_ms.encodec: host ms per batch inside the program's span
``serving.launch`` (``esc_tpu_torch/serving.py::stream_map``'s call that
enqueues a batch's ``encode_codes`` and ``decode_codes``) in EnCodec's
cell, in the traced batches. Once it nears the device's ms a batch, the
host sets the pace: the stage graphs' replays keep it far below."""

from portbench.spans import host_ms


def read(run):
    return host_ms(run, "serving.launch")
