"""A run whose timed path is broken underneath comes out not correct: the
harness's look for a card is skipped, the rest of a run is driven on the
CPU at a tiny size, and each fault the cell can have is planted in the
program:

- serving: a code altered where ``ESC.encode`` makes it; a waveform
  altered where ``ESC.decode`` makes it;
- training: a step that leaves the state unchanged; half of the batch left
  out, the mean taken over the rest; the state left unchanged only after
  set-up's steps, as a step captured once and replayed without its
  update would (the window's next step catches it)."""

import pytest

from portbench.tests.tiny import run_tiny


def _encode_altered(orig):
    def encode(self, x, num_streams):
        codes = orig(self, x, num_streams)
        codes = codes.clone()
        codes[0, 0, 0, 0] = (codes[0, 0, 0, 0] + 1) % self.codebook_size
        return codes
    return encode


def _decode_altered(orig):
    def decode(self, codes, feat_shape):
        wave = orig(self, codes, feat_shape).clone()
        wave[0, wave.shape[1] // 2] += 0.01 * wave.abs().max()
        return wave
    return decode


@pytest.mark.parametrize("workload", ["esc-base.serve-batch",
                                      "esc-base.serve-single"])
@pytest.mark.parametrize("fault", ["code", "wave"])
def test_serving_fault_is_caught(monkeypatch, workload, fault):
    from esc_tpu_torch.models.codecs import ESCModule
    if fault == "code":
        monkeypatch.setattr(ESCModule, "encode",
                            _encode_altered(ESCModule.encode))
    else:
        monkeypatch.setattr(ESCModule, "decode",
                            _decode_altered(ESCModule.decode))
    run, _ = run_tiny(workload)
    assert not run.correct, run.checks
    assert run.checks[f"{fault}_gap"]["value"] > \
        run.checks[f"{fault}_gap"]["limit"]


def _plant(monkeypatch, fault):
    from esc_tpu_torch.train.optim import AdamW
    from esc_tpu_torch.train.trainer import Trainer
    from esc_tpu_torch.train.trainer_adv import TrainerAdv

    if fault == "unchanged":
        monkeypatch.setattr(AdamW, "step", lambda self: None)
    elif fault == "unchanged_after_setup":
        orig_step = AdamW.step

        def step(self):
            if self.count < 3:
                orig_step(self)
        monkeypatch.setattr(AdamW, "step", step)
    elif fault == "half_batch":
        for cls in (Trainer, TrainerAdv):
            orig = cls.train_step

            def half(self, batch, num_streams, freeze, orig=orig):
                return orig(self, batch[:len(batch) // 2], num_streams,
                            freeze)
            monkeypatch.setattr(cls, "train_step", half)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch",
                                   "unchanged_after_setup"])
def test_training_fault_is_caught(monkeypatch, fault):
    _plant(monkeypatch, fault)
    run, _ = run_tiny("esc-base-adv.train")
    assert not run.correct, run.checks
    if fault == "unchanged_after_setup":
        # set-up's three steps are sound: only the window's step fails
        failed = {n for n, c in run.checks.items()
                  if c["value"] > c["limit"]}
        assert failed and all(n.startswith("window_") for n in failed)
