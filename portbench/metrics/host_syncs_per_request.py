"""host_syncs_per_request: synchronising CUDA calls (``*Synchronize*``, a
``cudaMemcpy`` that is not ``Async``, ``cudaFree``, ``cudaFreeHost``,
``cuMemFree*``; ``portbench/spans.py::is_sync``) inside the program's spans
``codec.encode`` and ``codec.decode``, over the traced requests."""

from portbench.spans import sync_calls


def read(run):
    return sync_calls(run, "codec.encode", "codec.decode")
