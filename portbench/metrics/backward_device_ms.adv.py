"""backward_device_ms.adv: device ms per step launched inside the program's
spans ``gen.backward`` and ``disc.backward`` (the generator's and the
discriminator's ``backward()``, ``esc_tpu_torch/train/trainer.py::
Trainer._backward``), in the traced steps."""

from portbench.spans import device_ms


def read(run):
    return device_ms(run, "gen.backward", "disc.backward")
