"""update_device_ms.adv: device ms per step launched inside the program's
spans ``gen.update`` and ``disc.update`` (gradient averaging over the
ranks, the clip and AdamW of both optimizers, ``esc_tpu_torch/train/
trainer.py::Trainer._update``), in the traced steps."""

from portbench.spans import device_ms


def read(run):
    return device_ms(run, "gen.update", "disc.update")
