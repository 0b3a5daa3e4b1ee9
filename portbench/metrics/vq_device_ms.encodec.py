"""vq_device_ms.encodec: device ms per batch launched inside the program's
``vq.*`` spans in EnCodec (the whole residual VQ, ``vq.s0``: in encode the
32 stages' Euclidean search, one ``torch.matmul`` and ``argmin`` each, and
residuals; in decode the gather and sum of the codewords;
``esc_tpu_torch/baselines/encodec/quantize.py``), in the traced
batches."""

from portbench.spans import device_ms


def read(run):
    if "Encodec" not in run.config:
        return None
    return device_ms(run, "vq.*")
