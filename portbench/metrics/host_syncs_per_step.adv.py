"""host_syncs_per_step.adv: synchronising CUDA calls (``*Synchronize*``, a
``cudaMemcpy`` that is not ``Async``, ``cudaFree``, ``cudaFreeHost``,
``cuMemFree*``; ``portbench/spans.py::is_sync``) inside the program's span
``train.step``, over the traced steps."""

from portbench.spans import sync_calls


def read(run):
    return sync_calls(run, "train.step")
