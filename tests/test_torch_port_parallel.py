"""The port's data-parallel training on the CPU: two gloo ranks against one
process on the global batch, for ``Trainer`` and ``TrainerAdv``, over 3
steps across the renewal (a freeze step, an adversarial step, the renewal
and one more with an evaluation); each rank's rows of the global batch; the
ranks ``--num_devices`` takes.

Tolerances: every logged loss of the two runs within rtol 1e-5 / atol 1e-6
(a global batch split over two ranks sums its gradients in another order);
the weights after the 3 steps differ between the runs by less than a tenth
of the distance they moved (L2 over all weights; see the test); the rows a
rank loads are exactly the one-process batch's.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from esc_tpu_torch.checkpoint import load_checkpoint
from esc_tpu_torch.convert import to_jax_params
from esc_tpu_torch.models import make_model
from esc_tpu_torch.models.discriminator import (Discriminator,
                                                init_discriminator)
from esc_tpu_torch.cli import train as train_cli
from esc_tpu_torch.io import save_wav
from esc_tpu_torch.parallel import DataParallel, process_is_main
from esc_tpu_torch.train import data as data_mod
from esc_tpu_torch.train import trainer as trainer_mod
from esc_tpu_torch.utils.config import write_yaml
from tests.test_torch_port_conv import one_torch_thread  # noqa: F401

TINY = dict(
    backbone="transformer", in_dim=2, in_freq=192,
    h_dims=[8, 8, 8, 8, 16, 16], max_streams=6, win_len=20, hop_len=5,
    sr=16000, patch_size=[3, 2], swin_heads=[2, 2, 2, 2, 2], swin_depth=1,
    window_size=4, mlp_ratio=2.0, overlap=2, group_size=3,
    codebook_size=64, codebook_dims=[4] * 6, l2norm=True)
DISC = {"sample_rate": 16000, "rates": [], "periods": [2],
        "fft_sizes": [256], "bands": [[0.0, 0.25], [0.25, 1.0]]}
# four training clips of unequal length (each, after the loader's 80-sample
# trim, a multiple of 80 whose quotient is 3 mod 4: the codec's grid): a
# rank's rows are cropped to the shortest clip of the whole global batch;
# two validation clips of 0.3 s
LENGTHS = (5440, 4800, 5120, 5760)
VAL_LENGTH = 4800
RANKS = 2
SEED = 5


@pytest.fixture(autouse=True)
def _drop_checkpoints(tmp_path):
    """Remove the checkpoints a test's runs wrote once it is done: with the
    discriminator and its moments they weigh up to ~0.2 GB each."""
    yield
    for path in tmp_path.rglob("*.ckpt"):
        path.unlink()


@pytest.fixture(scope="module")
def wav_folder(tmp_path_factory):
    """The training clips' folder; the validation clips' is beside it."""
    root = tmp_path_factory.mktemp("dp_wavs")
    rng = np.random.default_rng(9)
    for name, lengths in (("train", LENGTHS), ("val", (VAL_LENGTH,) * 2)):
        (root / name).mkdir()
        for i, n in enumerate(lengths):
            t = np.arange(n) / 16000.0
            x = 0.3 * np.sin(2 * np.pi * (110 + 45 * i) * t) \
                + 0.05 * rng.standard_normal(n)
            save_wav(str(root / name / f"clip_{i}.wav"), x.astype(np.float32))
    return str(root / "train")


def _config_path(tmp_path, wav_folder, adv, per_device):
    cfg = {"data": {"train_data_path": wav_folder,
                    "val_data_path": os.path.join(os.path.dirname(
                        wav_folder), "val"), "num_workers": 0,
                    "train_bs_per_device": per_device,
                    "val_bs_per_device": 2},
           "model_name": "csvq+swinT", "model": dict(TINY),
           "loss": {"stft_weight": 1.0, "cm_weight": 0.25,
                    "cb_weight": 1.0, "mel_weight": 0.25}}
    if adv:
        cfg["discriminator"] = dict(DISC)
        cfg["loss"].update(stft_weight=0.0, mel_weight=15.0, gen_weight=1.0,
                           feat_weight=2.0)
    path = os.path.join(tmp_path, f"cfg_{per_device}.yaml")
    write_yaml(path, cfg)
    return path


def _argv(config_path, save_path, adv):
    return ["--config_path", config_path, "--exp_name", "dp",
            "--save_path", str(save_path), "--num_epochs", "3",
            "--num_pretraining_epochs", "1", "--dropout_rate", "0.5",
            "--log_steps", "1", "--lr", "4e-4", "--seed", str(SEED),
            "--val_metric", "SISDR", "--device", "cpu"] + (
                ["--adv_training"] if adv else [])


def _record_logged(logged):
    """Have ``DataParallel.mean`` (which averages each log window's losses
    over the ranks) append what it returns on rank 0 to ``logged``, at full
    precision (the log lines print 4 decimals)."""
    mean = DataParallel.mean

    def recording(self, values):
        out = mean(self, values)
        if process_is_main():
            logged.append(out.tolist())
        return out
    return recording


def _recording_rank(rank, args, world, init_method, log_dir):
    """A rank as the train CLI spawns it (``train._rank``), with the files
    it writes, the lines it prints and the losses it logs recorded in
    ``log_dir/rank<r>.json``."""
    said, writes, logged = [], [], []
    save, write_yaml_ = trainer_mod.save_checkpoint, trainer_mod.write_yaml
    print0 = trainer_mod.print0
    DataParallel.mean = _record_logged(logged)

    def saving(path, tag, **kw):
        writes.append(tag)
        return save(path, tag, **kw)

    def writing(path, cfg):
        writes.append(os.path.basename(path))
        return write_yaml_(path, cfg)

    def printing(*a, **k):
        if process_is_main():
            said.append(" ".join(map(str, a)))
        print0(*a, **k)

    trainer_mod.save_checkpoint, trainer_mod.write_yaml = saving, writing
    trainer_mod.print0 = printing
    try:
        train_cli._rank(rank, args, world, init_method)
    finally:
        with open(os.path.join(log_dir, f"rank{rank}.json"), "w") as f:
            json.dump({"writes": writes, "said": said, "logged": logged}, f)


def _flat(gen, disc=None):
    out = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                out[prefix + k] = np.asarray(v)

    walk(gen, "gen/")
    walk(disc or {}, "disc/")
    return out


def _trees(path):
    payload = load_checkpoint(path)
    return _flat(payload["model_state_dict"],
                 payload.get("model_disc_state_dict"))


def _initial(adv):
    """The weights both runs start from (the trainers' seeded inits)."""
    gen = to_jax_params(make_model(TINY, seed=SEED, device="cpu").module)
    disc = to_jax_params(init_discriminator(Discriminator(**DISC),
                                            SEED + 1)) if adv else None
    return _flat(gen, disc)


@pytest.mark.parametrize("adv", [False, True], ids=["Trainer", "TrainerAdv"])
def test_two_ranks_equal_one_process_on_the_global_batch(
        wav_folder, tmp_path, monkeypatch, adv):
    """Every logged loss within rtol 1e-5 / atol 1e-6, the weights after 3
    steps within a tenth of the distance trained; only rank 0 writes
    files."""
    one_cfg = _config_path(tmp_path, wav_folder, adv, RANKS * 2)
    one = train_cli.parse_args(_argv(one_cfg, tmp_path / "one", adv))
    one_logged = []
    monkeypatch.setattr(DataParallel, "mean", _record_logged(one_logged))
    train_cli._trainer(one).train()

    dp_cfg = _config_path(tmp_path, wav_folder, adv, 2)
    args = train_cli.parse_args(_argv(dp_cfg, tmp_path / "dp", adv)
                                + ["--num_devices", str(RANKS)])
    torch.multiprocessing.spawn(
        _recording_rank, nprocs=RANKS, join=True,
        args=(args, RANKS, f"tcp://localhost:{train_cli._free_port()}",
              str(tmp_path)))
    ranks = [json.load(open(tmp_path / f"rank{r}.json"))
             for r in range(RANKS)]

    assert ranks[1]["writes"] == [] and ranks[1]["said"] == []
    assert ranks[0]["writes"] == ["config.yaml", "pretrained.ckpt",
                                  "best.ckpt", "checkpoint.ckpt",
                                  "checkpoint.ckpt"]
    assert sorted(os.listdir(tmp_path / "dp" / "dp")) == [
        "best.ckpt", "checkpoint.ckpt", "config.yaml", "pretrained.ckpt"]
    said = "\n".join(ranks[0]["said"])
    assert "Devices: 2 (cpu)  GlobalBatch: Train 4" in said
    assert len([ln for ln in ranks[0]["said"] if ln.startswith("[step ")]) \
        == len(ranks[0]["logged"]) == len(one_logged) == 3
    np.testing.assert_allclose(ranks[0]["logged"], one_logged, rtol=1e-5,
                               atol=1e-6)
    if adv:             # the last loss logged is the discriminator's
        assert one_logged[0][-1] == 0.0 and one_logged[1][-1] > 0.0
    ours = _trees(str(tmp_path / "dp" / "dp" / "checkpoint.ckpt"))
    theirs = _trees(str(tmp_path / "one" / "dp" / "checkpoint.ckpt"))
    start = _initial(adv)
    assert ours.keys() == theirs.keys() == start.keys()
    assert any(k.startswith("disc/") for k in ours) == adv
    # Adam divides each gradient element by its own magnitude, so an
    # element whose gradient is near the rounding of the batch sum (a bias
    # summed over many positions) may step either way in the two runs: the
    # weights are compared by the distance between the runs against the
    # distance trained, over all of them
    diff = sum(float(np.sum((ours[k] - theirs[k]) ** 2)) for k in theirs)
    moved = sum(float(np.sum((theirs[k] - start[k]) ** 2)) for k in theirs)
    assert moved > 0 and (diff / moved) ** 0.5 < 0.1, (diff, moved)


def test_each_rank_reads_its_rows_of_the_global_batch(wav_folder,
                                                      monkeypatch):
    """Rank r of 2 gets rows 2r, 2r+1 of each global batch of 4, in the
    one-process order, cropped to the global batch's shortest clip, and
    reads only those files' samples."""
    read = []
    get = data_mod.EvalSet.__getitem__
    monkeypatch.setattr(data_mod.EvalSet, "__getitem__",
                        lambda self, i: read.append(i) or get(self, i))
    whole = list(data_mod.make_dataloader(wav_folder, 4, True, seed=3))
    assert len(whole) == 1 and whole[0].shape == (4, min(LENGTHS) - 80)
    for rank in range(RANKS):
        dp = DataParallel("cpu")
        dp.num_devices, dp.rank = RANKS, rank
        read.clear()
        loader = data_mod.make_dataloader(wav_folder, 4, True, seed=3,
                                          shard=dp.shard)
        (rows,) = list(loader)
        assert len(loader) == 1 and len(read) == 2
        np.testing.assert_array_equal(rows, whole[0][2 * rank:2 * rank + 2])
    with pytest.raises(ValueError, match="split"):
        dp.shard(np.arange(5))


def test_num_devices_takes_the_devices_present(monkeypatch, capsys):
    """--num_devices beyond the cards present takes the cards present and
    prints the count; without it, every card; on the CPU, the ranks asked
    for (gloo)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert train_cli.num_ranks(8, "cuda") == 2
    assert train_cli.num_ranks(None, "cuda") == 2
    assert train_cli.num_ranks(1, "cuda") == 1
    assert train_cli.num_ranks(3, "cpu") == 3
    assert train_cli.num_ranks(None, "cpu") == 1
    spawned = []
    monkeypatch.setattr(train_cli.mp, "spawn",
                        lambda fn, args, nprocs, join: spawned.append(
                            (fn, args[1], nprocs)))
    assert train_cli.main(["--num_devices", "8", "--adv_training"]) is None
    assert spawned == [(train_cli._rank, 2, 2)]
    assert "Training on 2 cuda ranks" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert train_cli.main(["--num_devices", "1", "--device", "cpu"]) is None
    assert spawned[-1] == (train_cli._rank, 1, 1)
    assert "Training on 1 cpu rank" in capsys.readouterr().out


def test_torchrun_makes_each_process_a_rank(wav_folder, tmp_path):
    """Under torchrun's environment the CLI joins its process group: two
    CPU processes train one adversarial step as two ranks."""
    cfg = _config_path(tmp_path, wav_folder, True, 2)
    argv = _argv(cfg, tmp_path / "run", True)
    argv[argv.index("--num_epochs") + 1] = "1"
    argv[argv.index("--num_pretraining_epochs") + 1] = "0"
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "esc_tpu_torch.cli.train", *argv],
        capture_output=True, text=True, timeout=300,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.count("Devices: 2 (cpu)  GlobalBatch: Train 4") == 1
    assert "disc_loss" in proc.stdout
    assert (tmp_path / "run" / "dp" / "checkpoint.ckpt").exists()
