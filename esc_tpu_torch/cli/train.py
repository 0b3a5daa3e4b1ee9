"""Training entry point (port of the repo's ``main.py``).

    python -m esc_tpu_torch.cli.train --config_path configs/9kbps_esc_base.yaml \
        --exp_name esc9kbps --num_epochs 80 --num_pretraining_epochs 15 \
        --dropout_rate 0.75 --seed 53

The flags are ``main.py``'s, plus ``--device``. One GPU trains;
``--num_devices`` above 1 and ``--adv_training`` are refused until
multi-GPU and adversarial training are ported.
"""

from __future__ import annotations

import argparse

from ..train.trainer import Trainer
from ..utils.config import read_yaml

__all__ = ["parse_args", "main"]


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


def main(argv=None):
    args = parse_args(argv)
    if args.adv_training:
        raise NotImplementedError("adversarial training is not ported yet")
    if args.num_devices is not None and args.num_devices > 1:
        raise NotImplementedError(
            f"--num_devices {args.num_devices}: training on several GPUs is "
            "not ported yet; one GPU trains")
    trainer = Trainer(read_yaml(args.config_path), args)
    if args.wandb_project:
        try:
            import wandb
        except ImportError:
            print("wandb not installed; logging to stdout only")
        else:
            wandb.init(project=args.wandb_project, name=args.exp_name)
            trainer.wandb = wandb
    return trainer.train()


if __name__ == "__main__":
    main()
