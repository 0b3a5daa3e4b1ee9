"""Training entry point (port of the repo's ``main.py``).

    python -m esc_tpu_torch.cli.train --config_path configs/9kbps_esc_base.yaml \
        --exp_name esc9kbps --num_epochs 80 --num_pretraining_epochs 15 \
        --dropout_rate 0.75 --seed 53

The flags are ``main.py``'s, plus ``--device``. ``--adv_training`` trains
with the discriminator (:class:`~esc_tpu_torch.train.trainer_adv.TrainerAdv`).
``--num_devices N`` trains on N ranks of this host, one process per card
(NCCL), as many as there are cards where N is larger, the loader's batch
being ``train_bs_per_device`` times the ranks; with ``--device cpu`` the
ranks are N CPU processes (gloo). Without ``--num_devices``, every card of
the host trains, and one process trains where there is one card. Under
``torchrun`` (its environment set), each process is one rank of its
process group, which may span hosts.
"""

from __future__ import annotations

import argparse
import os
import socket
from typing import Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..device import resolve_device
from ..parallel import init_distributed, process_is_main
from ..train.trainer import Trainer
from ..train.trainer_adv import TrainerAdv
from ..utils.config import read_yaml

__all__ = ["parse_args", "main", "num_ranks"]


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="esc_tpu_torch.cli.train")
    p.add_argument("--exp_name", default="esc9kbps", type=str)
    p.add_argument("--wandb_project", default=None, type=str)
    p.add_argument("--lr", default=1.0e-4, type=float)
    p.add_argument("--num_epochs", default=80, type=int)
    p.add_argument("--num_pretraining_epochs", default=10, type=int)
    p.add_argument("--num_devices", default=None, type=int)
    p.add_argument("--num_warmup_steps", default=0, type=int)
    p.add_argument("--val_metric", default="PESQ", type=str)
    p.add_argument("--scheduler_type", default="constant", type=str)
    p.add_argument("--dropout_rate", type=float, default=1.0)
    p.add_argument("--adv_training", default=False, action="store_true")
    p.add_argument("--pretrain_ckp", type=str, default=None)
    p.add_argument("--resume", default=False, action="store_true",
                   help="auto-resume from the rolling checkpoint")
    p.add_argument("--log_steps", default=5, type=int)
    p.add_argument("--save_path", default="./output", type=str)
    p.add_argument("--config_path",
                   default="./configs/9kbps_esc_base.yaml")
    p.add_argument("--seed", default=1234, type=int)
    p.add_argument("--device", default="cuda", type=str,
                   help="torch device (default cuda; cpu runs the plain "
                        "PyTorch versions of the kernels)")
    return p.parse_args(argv)


def num_ranks(num_devices: Optional[int], device: str) -> int:
    """The ranks ``--num_devices`` asks for: capped at the cards present on
    ``cuda``, as ``main.py`` slices ``jax.devices()``; every card where it
    is not given. On the CPU, the number asked for (1 by default)."""
    if torch.device(device).type != "cuda":
        return max(1, num_devices or 1)
    resolve_device(device)                  # raises without CUDA
    present = torch.cuda.device_count()
    return present if num_devices is None else max(1, min(num_devices,
                                                          present))


def _trainer(args, device=None):
    config = read_yaml(args.config_path)
    cls = TrainerAdv if args.adv_training else Trainer
    trainer = cls(config, args, device=device)
    if args.wandb_project and process_is_main():
        try:
            import wandb
        except ImportError:
            print("wandb not installed; logging to stdout only")
        else:
            wandb.init(project=args.wandb_project, name=args.exp_name)
            trainer.wandb = wandb
    return trainer


def _rank(rank: int, args, world: int, init_method: str) -> None:
    """One spawned rank: join the group, train on this rank's card."""
    device = torch.device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    else:           # the host's cores shared among its CPU ranks
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    init_distributed(device, init_method, world, rank)
    try:
        _trainer(args, device).train()
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main(argv=None):
    """Train as the flags say; returns the model where this process
    trained alone, else None."""
    args = parse_args(argv)
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:      # under torchrun
        device = torch.device(args.device)
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
            torch.cuda.set_device(device)
        init_distributed(device)
        try:
            return _trainer(args, device).train()
        finally:
            dist.destroy_process_group()
    world = num_ranks(args.num_devices, args.device)
    if args.num_devices is None and world == 1:
        return _trainer(args).train()
    print(f"Training on {world} {torch.device(args.device).type} "
          f"rank{'s' if world > 1 else ''}", flush=True)
    mp.spawn(_rank, args=(args, world, f"tcp://localhost:{_free_port()}"),
             nprocs=world, join=True)
    return None


if __name__ == "__main__":
    main()
