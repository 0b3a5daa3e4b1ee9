"""host_enqueue_ms.serve: host ms per batch inside the program's span
``serving.launch`` (``esc_tpu_torch/serving.py::stream_map``'s call that
enqueues a batch's encode and decode), in the traced batches. Once it
nears the device's ms a batch, the host sets the pace."""

from portbench.spans import host_ms


def read(run):
    return host_ms(run, "serving.launch")
