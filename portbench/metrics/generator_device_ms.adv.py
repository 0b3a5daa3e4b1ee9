"""generator_device_ms.adv: device ms per step launched inside the
benchmark's span around the trainer instance's ``generator_step``
(``esc_tpu_torch/train/trainer_adv.py``), in the traced steps."""

from portbench.readers import span_ms


def read(run):
    return span_ms(run, "trainer.generator_step")
