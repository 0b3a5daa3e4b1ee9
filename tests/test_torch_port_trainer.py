"""The port's trainer against the JAX package's, downsized: the same seed
gives the same batches, stream counts, freeze flags, renewal, evaluations
and checkpoints; a resumed run equals an uninterrupted one; the checkpoints
it writes load into both packages; the train CLI's refusals.

Tolerances: a resumed run's parameters and moments within 1e-6 of the
uninterrupted run's (as tests/test_resume.py holds the JAX package);
codes from a port-written ``best.ckpt`` bit-exact in both packages.
"""

import argparse
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esc_tpu.utils import dict2namespace
from esc_tpu_torch.checkpoint import load_checkpoint
from esc_tpu_torch.cli import train as train_cli
from esc_tpu_torch.io import save_wav
from esc_tpu_torch.train import trainer as port_trainer
from tests.test_torch_port_conv import one_torch_thread  # noqa: F401

TINY = dict(
    backbone="transformer", in_dim=2, in_freq=192,
    h_dims=[8, 8, 8, 8, 16, 16], max_streams=6, win_len=20, hop_len=5,
    sr=16000, patch_size=[3, 2], swin_heads=[2, 2, 2, 2, 2], swin_depth=1,
    window_size=4, mlp_ratio=2.0, overlap=2, group_size=3,
    codebook_size=64, codebook_dims=[4] * 6, l2norm=True)


@pytest.fixture(scope="module")
def wav_folder(tmp_path_factory):
    """Six clips of 0.5 s (7,920 samples after the trim: an even number of
    STFT frames), harmonics and noise."""
    d = tmp_path_factory.mktemp("train_wavs")
    rng = np.random.default_rng(7)
    t = np.arange(8000) / 16000.0
    for i in range(6):
        x = 0.3 * np.sin(2 * np.pi * (100 + 40 * i) * t) \
            + 0.05 * rng.standard_normal(t.shape)
        save_wav(str(d / f"clip_{i}.wav"), x.astype(np.float32))
    return str(d)


def _config(wav_folder):
    return {"data": {"train_data_path": wav_folder,
                     "val_data_path": wav_folder, "num_workers": 0,
                     "train_bs_per_device": 2, "val_bs_per_device": 3},
            "model_name": "csvq+swinT", "model": dict(TINY),
            "loss": {"stft_weight": 1.0, "cm_weight": 0.25, "cb_weight": 1.0,
                     "mel_weight": 0.25}}


def _args(save_path, num_epochs, pretraining=1, resume=False, seed=11):
    return argparse.Namespace(
        exp_name="port_run", lr=4e-4, num_epochs=num_epochs,
        num_pretraining_epochs=pretraining, num_warmup_steps=0,
        val_metric="PESQ", scheduler_type="constant", dropout_rate=0.5,
        pretrain_ckp=None, log_steps=2, save_path=str(save_path), seed=seed,
        resume=resume, device="cpu")


def test_same_seed_same_schedule_of_work_as_the_jax_trainer(
        wav_folder, tmp_path, monkeypatch, capsys):
    """Both trainers with their steps, evaluations and saves recorded: the
    same batches in the same order, the same stream counts and freeze
    flags, one renewal, and evaluations and checkpoints at the same steps
    (4 epochs of 3 steps, the first epoch pretraining)."""
    from esc_tpu.train import trainer as jax_trainer

    events = {"jax": [], "port": []}

    def jax_step_fn(self, module):
        def step(state, batch, num_streams, freeze):
            events["jax"].append(("step", np.asarray(batch).tobytes(),
                                  int(num_streams), freeze))
            return state, {"loss": jnp.float32(0.0)}
        return step

    def port_step(self, batch, num_streams, freeze):
        events["port"].append(("step", np.asarray(batch).tobytes(),
                               num_streams, freeze))
        return {"loss": torch.zeros(())}

    for name, cls in (("jax", jax_trainer.Trainer),
                      ("port", port_trainer.Trainer)):
        monkeypatch.setattr(cls, "evaluate", lambda self, step, n=name:
                            events[n].append(("eval", step)))
        monkeypatch.setattr(cls, "save_ckp",
                            lambda self, *a, n=name, tag=None, **k:
                            events[n].append(("save", a[-1], tag)))
    monkeypatch.setattr(jax_trainer.Trainer, "_make_step_fn", jax_step_fn)
    monkeypatch.setattr(port_trainer.Trainer, "train_step", port_step)
    cfg = _config(wav_folder)
    jt = jax_trainer.Trainer(dict2namespace(copy.deepcopy(cfg)),
                             _args(tmp_path / "jax", 4),
                             devices=jax.devices()[:1])
    jt.train()
    jax_said = capsys.readouterr().out
    pt = port_trainer.Trainer(copy.deepcopy(cfg), _args(tmp_path / "port", 4))
    pt.train()
    port_said = capsys.readouterr().out
    assert len(events["port"]) == len(events["jax"]) > 12
    assert events["port"] == events["jax"]
    assert jax_said.count("Optimizer Renewed") == 1
    assert port_said.count("Optimizer Renewed") == 1
    steps = [e for e in events["port"] if e[0] == "step"]
    assert [e[3] for e in steps] == [True] * 3 + [False] * 9
    assert {e[2] for e in steps} - {6}      # dropout drew other counts
    assert ("save", 3, "pretrained.ckpt") in events["port"]
    assert ("eval", 6) in events["port"] and ("eval", 9) in events["port"]


def _leaves(model):
    return [p.detach().numpy().copy() for p in model.module.parameters()]


@pytest.fixture(scope="module")
def runs(wav_folder, tmp_path_factory):
    """The port trained 4 epochs in one go, and 2 epochs then resumed to 4
    by a fresh trainer."""
    cfg = _config(wav_folder)
    a_dir = tmp_path_factory.mktemp("run_a")
    ta = port_trainer.Trainer(copy.deepcopy(cfg), _args(a_dir, 4))
    model_a = ta.train()
    b_dir = tmp_path_factory.mktemp("run_b")
    port_trainer.Trainer(copy.deepcopy(cfg), _args(b_dir, 2)).train()
    tb = port_trainer.Trainer(copy.deepcopy(cfg),
                              _args(b_dir, 4, resume=True))
    model_b = tb.train()
    return (ta, model_a, a_dir), (tb, model_b, b_dir)


def test_resumed_run_equals_the_uninterrupted_one(runs):
    (ta, model_a, _), (tb, model_b, _) = runs
    assert tb.start_step == 6     # resumed right after the last step
    for a, b in zip(_leaves(model_a), _leaves(model_b)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    assert ta.opt.count == tb.opt.count == 8   # counted from the renewal
    for a, b in zip(ta.opt.mu + ta.opt.nu, tb.opt.mu + tb.opt.nu):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)
    assert ta.rng.bit_generator.state == tb.rng.bit_generator.state


def test_checkpoints_carry_the_jax_packages_layout(runs):
    (ta, model_a, a_dir), _ = runs
    exp = a_dir / "port_run"
    for tag in ("pretrained.ckpt", "best.ckpt", "checkpoint.ckpt"):
        assert (exp / tag).exists(), tag
    assert not list(exp.glob("*.tmp"))
    payload = load_checkpoint(str(exp / "checkpoint.ckpt"))
    assert set(payload) == {"step", "model_state_dict",
                            "optimizer_state_dict", "scheduler_state_dict",
                            "best_perf", "rng_state"}
    assert payload["step"] == 11   # the last completed step's index
    assert payload["scheduler_state_dict"] == {"type": "constant",
                                               "step": 11}
    assert isinstance(payload["rng_state"], str)
    # optax's state of chain(clip, adamw(schedule)): Adam's count and the
    # schedule's, counted from the renewal
    adamw = payload["optimizer_state_dict"]["1"]
    assert adamw["0"]["count"] == adamw["2"]["count"] == 8
    assert np.isfinite(payload["best_perf"])
    assert load_checkpoint(str(exp / "pretrained.ckpt"))["step"] == 3


def test_port_checkpoint_gives_the_same_codes_in_both_packages(runs, rng):
    from esc_tpu.cli.compress import load_model as jax_load_model
    from esc_tpu_torch.cli.compress import load_model

    (_, _, a_dir), _ = runs
    exp = str(a_dir / "port_run")
    ref = jax_load_model(exp)
    port = load_model(exp, device="cpu")
    x = (0.1 * rng.standard_normal((2, 7920))).astype(np.float32)
    for ns in (1, 6):
        theirs, _ = ref.encode(x, num_streams=ns)
        ours, _ = port.encode(x, num_streams=ns)
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


def test_train_cli_refuses_what_is_not_ported(monkeypatch, tmp_path):
    """Every flag of main.py is taken (adversarial and multi-GPU training
    are ported: tests/test_torch_port_adv_train.py,
    tests/test_torch_port_parallel.py); what the CLI refuses is a run on
    the card where there is none."""
    args = train_cli.parse_args(["--adv_training", "--num_devices", "2"])
    assert args.adv_training and args.num_devices == 2
    args = train_cli.parse_args([])
    assert args.device == "cuda" and args.seed == 1234
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for extra in ([], ["--adv_training"], ["--num_devices", "2"]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train_cli.main(["--save_path", str(tmp_path)] + extra)
