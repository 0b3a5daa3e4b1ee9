"""The port's adversarial trainer against the JAX package's, downsized:
one freeze step and one adversarial step (losses, both sides' gradients,
the discriminator left as it was in the freeze step), ``--pretrain_ckp``'s
learning rates, checkpoints read across the packages and ``--resume``.

The generator is the verify skill's tiny ESC and the discriminator that of
``tests/test_torch_port_adv.py`` with two bands; weights are made by the
JAX package and carried into the port
(``esc_tpu_torch.convert.from_jax_params``); inputs come from numpy seeds.
Tolerances, each stated where it is used: a step's losses rtol 5e-4 and
each gradient leaf's cosine above 0.995 (``tests/test_torch_port_train.py``'s
bars); schedules rtol 1e-5; carried weights exact.
"""

import argparse
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esc_tpu.models import ESC as JaxESC
from esc_tpu.modules.gan_loss import discriminator_loss as jax_disc_loss
from esc_tpu.modules.gan_loss import generator_loss as jax_gen_loss
from esc_tpu.modules.losses import mel_spectrogram_loss as jax_mel_loss
from esc_tpu_torch.checkpoint import load_checkpoint
from esc_tpu_torch.convert import from_jax_params, to_jax_params
from esc_tpu_torch.io import save_wav
from esc_tpu_torch.models.discriminator import init_discriminator
from esc_tpu_torch.train import trainer_adv as port_trainer_adv
from tests.test_torch_port_adv import _flat, _pair
from tests.test_torch_port_conv import one_torch_thread  # noqa: F401

# the verify skill's tiny ESC and the small discriminator with two bands
TINY = dict(
    backbone="transformer", in_dim=2, in_freq=192,
    h_dims=[12, 12, 16, 16, 24, 32], max_streams=6, win_len=20, hop_len=5,
    sr=16000, patch_size=[3, 2], swin_heads=[2, 2, 2, 2, 2], swin_depth=1,
    window_size=4, mlp_ratio=2.0, overlap=2, group_size=3,
    codebook_size=64, codebook_dims=[8] * 6, l2norm=True)
STEP_DISC = {"sample_rate": 16000, "rates": [], "periods": [2, 3],
             "fft_sizes": [512, 256], "bands": [[0.0, 0.25], [0.25, 1.0]]}
LOSS = {"stft_weight": 0.0, "cm_weight": 0.25, "cb_weight": 1.0,
        "mel_weight": 15.0, "gen_weight": 1.0, "feat_weight": 2.0}
STEP_L = 4720          # T = 60 STFT frames, tests/test_torch_port_train.py's


@pytest.fixture(autouse=True)
def _drop_checkpoints(tmp_path):
    """Remove the checkpoints a test's runs wrote once it is done: with the
    discriminator and its moments they weigh up to ~0.2 GB each."""
    yield
    for path in tmp_path.rglob("*.ckpt"):
        path.unlink()


@pytest.fixture(scope="module")
def wav_folder(tmp_path_factory):
    """Four clips of 0.3 s (4,720 samples after the trim)."""
    d = tmp_path_factory.mktemp("adv_wavs")
    r = np.random.default_rng(5)
    t = np.arange(STEP_L + 80) / 16000.0
    for i in range(4):
        x = 0.3 * np.sin(2 * np.pi * (120 + 50 * i) * t) \
            + 0.05 * r.standard_normal(t.shape)
        save_wav(str(d / f"clip_{i}.wav"), x.astype(np.float32))
    return str(d)


def _config(wav_folder):
    return {"data": {"train_data_path": wav_folder,
                     "val_data_path": wav_folder, "num_workers": 0,
                     "train_bs_per_device": 2, "val_bs_per_device": 2},
            "model_name": "csvq+swinT", "model": dict(TINY),
            "discriminator": copy.deepcopy(STEP_DISC), "loss": dict(LOSS)}


def _args(save_path, num_epochs=2, pretraining=1, pretrain_ckp=None,
          seed=11, scheduler_type="constant"):
    return argparse.Namespace(
        exp_name="adv_run", lr=4e-4, num_epochs=num_epochs,
        num_pretraining_epochs=pretraining, num_warmup_steps=2,
        val_metric="SISDR",
        scheduler_type=scheduler_type, dropout_rate=0.5,
        pretrain_ckp=pretrain_ckp, log_steps=1, save_path=str(save_path),
        seed=seed, resume=False, device="cpu")


@pytest.fixture(scope="module")
def jax_models():
    """The JAX generator (tiny ESC), its discriminator's jitted ``apply``
    and the discriminator's parameters."""
    ref = JaxESC(**TINY)
    ref.init_params(seed=3, example_len=STEP_L)
    apply, d_params, _ = _pair(STEP_DISC, STEP_L, seed=4)
    return ref, apply, d_params


@pytest.fixture(scope="module")
def step_pair(jax_models, wav_folder, tmp_path_factory):
    """A port TrainerAdv whose generator and discriminator carry the JAX
    model's and discriminator's weights; the JAX side."""
    ref, apply, d_params = jax_models
    t = port_trainer_adv.TrainerAdv(_config(wav_folder),
                                    _args(tmp_path_factory.mktemp("step")))
    t.model, _, t.val_dl = t.load()
    t.model.load_state_dict(from_jax_params(jax.tree.map(
        np.asarray, ref.variables)))
    t.disc.load_state_dict(from_jax_params(d_params))
    return t, ref, apply, d_params


def _jax_step(ref, disc_apply, d_params, batch, num_streams, freeze):
    """The JAX trainer's step (esc_tpu/train/trainer_adv.py:96-151) without
    the optimizers: losses, the generator's gradient and the
    discriminator's on the reconstruction."""
    module = ref.module

    def gen_loss_fn(p, d_params):
        out = module.apply({"params": p}, batch, None, num_streams, freeze,
                           True)
        mel = jax_mel_loss(out["raw_audio"], out["recon_audio"])
        if freeze:
            gen = feat = jnp.zeros_like(mel)
        else:
            gen, feat = jax_gen_loss(disc_apply, d_params,
                                     out["recon_audio"], out["raw_audio"])
        total = (out["cm_loss"] * LOSS["cm_weight"]
                 + out["cb_loss"] * LOSS["cb_weight"]
                 + mel * LOSS["mel_weight"] + gen * LOSS["gen_weight"]
                 + feat * LOSS["feat_weight"])
        aux = {"cm_loss": out["cm_loss"].mean(),
               "cb_loss": out["cb_loss"].mean(), "mel_loss": mel.mean(),
               "gen_loss": gen.mean(), "feat_loss": feat.mean()}
        return total.mean(), (aux, out["recon_audio"])

    (loss, (aux, recon)), grads = jax.jit(jax.value_and_grad(
        gen_loss_fn, has_aux=True))(ref.variables["params"], d_params)
    aux["loss"] = loss
    d_grads = None
    if not freeze:
        aux["disc_loss"], d_grads = jax.jit(jax.value_and_grad(
            lambda dp, fake, real: jax_disc_loss(disc_apply, dp, fake,
                                                 real).mean()))(
            d_params, recon, batch)
    return aux, grads, d_grads


def _assert_grads_agree(params, jax_grads, what):
    """Each leaf's cosine above 0.995; a leaf off the loss's path is zero
    on both sides."""
    theirs = from_jax_params(jax.tree.map(np.asarray, jax_grads))
    checked = 0
    for name, p in params:
        g = torch.zeros_like(p) if p.grad is None else p.grad
        g, jg = g.detach().numpy().ravel(), theirs[name].numpy().ravel()
        gn, jn = np.linalg.norm(g), np.linalg.norm(jg)
        if gn > 1e-8 and jn > 1e-8:
            cos = float(np.dot(g, jg) / (gn * jn))
            assert cos > 0.995, (what, name, cos)
            checked += 1
        else:
            assert gn <= 1e-8 and jn <= 1e-8, (what, name, gn, jn)
    return checked


@pytest.mark.parametrize("freeze", [True, False], ids=["freeze", "adv"])
def test_adversarial_step_matches_jax(step_pair, freeze, rng):
    """Losses rtol 5e-4; the generator's and the discriminator's gradients
    cosine > 0.995 per leaf; no generator-side gradient in the
    discriminator; in the freeze step the discriminator and its optimizer
    left as they were."""
    t, ref, disc_apply, d_params = step_pair
    gen_state = copy.deepcopy(t.model.state_dict())
    disc_state = copy.deepcopy(t.disc.state_dict())
    count = t.opt_disc.count
    try:
        batch = (0.1 * rng.standard_normal((2, STEP_L))).astype(np.float32)
        theirs, grads, d_grads = _jax_step(ref, disc_apply, d_params,
                                           jnp.asarray(batch), 6, freeze)
        x = torch.from_numpy(batch)
        aux, recon = t.generator_step(x, 6, freeze)
        assert all(p.grad is None for p in t.disc.parameters())
        aux["disc_loss"] = t.discriminator_step(recon, x, freeze)
        for k, v in theirs.items():
            np.testing.assert_allclose(float(aux[k]), float(v), rtol=5e-4,
                                       atol=1e-7, err_msg=k)
        assert aux["stft_loss"] >= 0.0
        assert _assert_grads_agree(t.model.module.named_parameters(), grads,
                                   "generator") > 30
        if freeze:
            assert float(aux["gen_loss"]) == float(aux["feat_loss"]) == \
                float(aux["disc_loss"]) == 0.0
            assert t.opt_disc.count == count
            for k, v in t.disc.state_dict().items():
                assert torch.equal(v, disc_state[k]), k
            assert all(p.grad is None for p in t.disc.parameters())
        else:
            assert float(aux["gen_loss"]) > 0 and float(aux["disc_loss"]) > 0
            assert t.opt_disc.count == count + 1
            assert _assert_grads_agree(t.disc.named_parameters(), d_grads,
                                       "discriminator") > 20
            assert not torch.equal(t.disc.state_dict()["discriminators.0."
                                                       "convs.0.weight_v"],
                                   disc_state["discriminators.0.convs.0."
                                              "weight_v"])
    finally:
        t.model.load_state_dict(gen_state)
        t.disc.load_state_dict(disc_state)


# ------------------------------------------------- learning rates, files
def test_pretrain_ckp_learning_rates_match_jax(wav_folder, tmp_path,
                                               monkeypatch):
    """--pretrain_ckp: the generator's schedule is the JAX trainer's, the
    JAX package's schedule divided by 10 (rtol 1e-5 at every step), the
    discriminator's the constant lr; the
    step count and best score restart, both optimizers' states are kept
    and one evaluation runs, at step -1, before the first step."""
    from esc_tpu.train.optim import make_schedule as jax_make_schedule

    kw = dict(num_epochs=1, pretraining=0, scheduler_type="cosine_warmup")
    first = port_trainer_adv.TrainerAdv(_config(wav_folder),
                                        _args(tmp_path / "a", **kw))
    first.train()
    ckp = str(tmp_path / "a" / "adv_run" / "checkpoint.ckpt")
    saved = load_checkpoint(ckp)
    # optax's state of chain(clip, adamw) at a constant rate: no schedule
    # count (esc_tpu/train/trainer_adv.py:68)
    assert saved["optimizer_disc_state_dict"]["1"]["0"]["count"] == 2
    assert saved["optimizer_disc_state_dict"]["1"]["2"] == {}

    evals = []
    monkeypatch.setattr(port_trainer_adv.TrainerAdv, "evaluate",
                        lambda self, step: evals.append(step))
    ours = port_trainer_adv.TrainerAdv(
        _config(wav_folder), _args(tmp_path / "b", pretrain_ckp=ckp, **kw))
    ours.train()
    assert evals == [-1] and ours.start_step == 0
    assert ours.args.lr == pytest.approx(4e-5) and ours.args.lr_disc == 4e-4

    # the JAX trainer's: its schedule from make_schedule, divided by 10
    # (esc_tpu/train/trainer_adv.py:45-50), over the same steps
    theirs = jax_make_schedule("cosine_warmup", 4e-4,
                               total_steps=ours.args.max_train_steps,
                               warmup_steps=2)
    for step in range(8):
        np.testing.assert_allclose(ours.schedule(step),
                                   float(theirs(jnp.int32(step))) / 10.0,
                                   rtol=1e-5, atol=1e-12, err_msg=step)
        assert ours.opt_disc.schedule(step) == pytest.approx(4e-4)
    # the finetuning went on from the file's moments: 2 + 2 more steps
    assert ours.opt_disc.count == 4 and ours.opt.count == 4


def test_checkpoints_carry_the_discriminator_across_packages(
        jax_models, wav_folder, tmp_path):
    """A checkpoint esc_tpu's TrainerAdv writes gives the port its
    discriminator (and generator) weights exactly, and both optimizers'
    counts and moments (two optax updates on random gradients) bit for
    bit; a port one restores into esc_tpu's discriminator parameters and
    both optimizer states (``restore_into`` against the flax tree and the
    optimizers' ``init``) with the port's values exactly. (That equal
    weights give equal feature maps is tests/test_torch_port_adv.py's.)"""
    from esc_tpu.checkpoint import restore_into
    from esc_tpu.train.optim import make_optimizer
    from esc_tpu.train.optim import make_schedule as jax_make_schedule
    from esc_tpu.train.trainer_adv import TrainerAdv as JaxTrainerAdv
    from esc_tpu.utils import dict2namespace

    ref, _, d_params = jax_models
    jt = JaxTrainerAdv(dict2namespace(_config(wav_folder)),
                       _args(tmp_path / "jax"), devices=jax.devices()[:1])
    # the state its train() holds; its load() would build the same models
    # and optimizers (esc_tpu/train/trainer_adv.py:52,68)
    jt.model, jt.best_perf = ref, float("-inf")
    params = ref.variables["params"]
    tx = make_optimizer(jax_make_schedule("constant", 4e-4), clip_norm=1e3)
    tx_disc = make_optimizer(4e-4, clip_norm=10.0)
    r = np.random.default_rng(8)
    states = []
    for t, p in ((tx, params), (tx_disc, d_params)):
        state = t.init(p)
        for _ in range(2):
            g = jax.tree.map(lambda a: jnp.asarray(r.standard_normal(
                a.shape).astype(np.float32)), p)
            _, state = t.update(g, state, p)
        states.append(state)
    jt.save_ckp((params, states[0], d_params, states[1]), 4,
                tag="checkpoint.ckpt")
    jax_ckp = str(tmp_path / "jax" / "adv_run" / "checkpoint.ckpt")

    pt = port_trainer_adv.TrainerAdv(_config(wav_folder),
                                     _args(tmp_path / "port"))
    pt.model, _, pt.val_dl = pt.load()
    pt._load_resume(jax_ckp)
    assert pt.start_step == 5
    assert pt.opt.count == pt.opt_disc.count == 2
    for opt, state in ((pt.opt, states[0]), (pt.opt_disc, states[1])):
        adam = state[1][0]
        for ours, tree in ((opt.mu, adam.mu), (opt.nu, adam.nu)):
            theirs = from_jax_params(jax.tree.map(np.asarray, tree))
            for name, m in zip(opt.names, ours):
                np.testing.assert_array_equal(m.numpy(),
                                              theirs[name].numpy(), name)
    want = _flat(jax.tree.map(np.asarray, d_params))
    got = _flat(to_jax_params(pt.disc))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k, v in _flat(to_jax_params(pt.model.module)).items():
        np.testing.assert_array_equal(v, _flat(jax.tree.map(
            np.asarray, params))[k], err_msg=k)

    init_discriminator(pt.disc, 99)          # weights unlike the JAX ones
    pt.save_ckp(0, tag="checkpoint.ckpt")
    port_ckp = str(tmp_path / "port" / "adv_run" / "checkpoint.ckpt")
    restored = restore_into(
        port_ckp, params, optimizer_state_target=tx.init(params),
        extra_targets={"model_disc_state_dict": d_params,
                       "optimizer_disc_state_dict": tx_disc.init(d_params)})
    loaded = _flat(jax.tree.map(np.asarray,
                                restored["model_disc_state_dict"]))
    ours = _flat(to_jax_params(pt.disc))
    assert set(loaded) == set(ours)
    for k, v in loaded.items():
        np.testing.assert_array_equal(v, ours[k], err_msg=k)
    for key, opt in (("optimizer_state_dict", pt.opt),
                     ("optimizer_disc_state_dict", pt.opt_disc)):
        adam = restored[key][1][0]
        assert int(adam.count) == opt.count == 2
        loaded = _flat(jax.tree.map(np.asarray, adam.nu))
        ours = _flat(to_jax_params(opt.module, dict(zip(opt.names,
                                                        opt.nu))))
        assert set(loaded) == set(ours)
        for k, v in loaded.items():
            np.testing.assert_array_equal(v, ours[k], err_msg=k)


def test_resume_restores_the_discriminator(wav_folder, tmp_path):
    """--resume: 2 adversarial steps, then 2 more from the rolling
    checkpoint, equal 4 in one go (atol 1e-6, as the non-adversarial
    resume test): the discriminator, its optimizer and the generator's are
    restored, not made afresh."""
    kw = dict(pretraining=0)
    whole = port_trainer_adv.TrainerAdv(_config(wav_folder),
                                        _args(tmp_path / "a", **kw))
    whole.train()
    port_trainer_adv.TrainerAdv(
        _config(wav_folder), _args(tmp_path / "b", num_epochs=1, **kw)).train()
    resumed = port_trainer_adv.TrainerAdv(_config(wav_folder),
                                          _args(tmp_path / "b", **kw))
    resumed.args.resume = True
    resumed.train()
    assert resumed.start_step == 2
    assert whole.opt_disc.count == resumed.opt_disc.count == 4
    for a, b in ((whole.disc, resumed.disc),
                 (whole.model.module, resumed.model.module)):
        for (k, p), q in zip(a.named_parameters(), b.parameters()):
            np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(),
                                       rtol=0, atol=1e-6, err_msg=k)
    for m, n in zip(whole.opt_disc.mu + whole.opt_disc.nu,
                    resumed.opt_disc.mu + resumed.opt_disc.nu):
        np.testing.assert_allclose(m.numpy(), n.numpy(), rtol=0, atol=1e-6)
