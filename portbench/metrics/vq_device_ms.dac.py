"""vq_device_ms.dac: device ms per batch launched inside the program's
``vq.*`` spans in the DAC (the whole residual VQ, ``vq.s0``: in encode its
stages' projections, normalisation, codebook argmin and residual, in
decode ``from_codes``; ``esc_tpu_torch/baselines/dac/quantize.py``), in
the traced batches."""

from portbench.spans import device_ms


def read(run):
    return device_ms(run, "vq.*")
