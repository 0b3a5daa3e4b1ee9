"""Evaluation CLI (port of ``esc_tpu/cli/test.py``; reference:
scripts/test.py:57-118).

    python -m esc_tpu_torch.cli.test \\
        --eval_folder_path ./eval_set --batch_size 12 \\
        --model_path ./esc9kbps

Sweeps every bitrate (or one, ``--num_streams``) and writes
``{save_path}/perf_stats.json`` in the reference's layout: each metric
(``PESQ``, ``MelDistance``, ``SISDR``, ``STOI``, ``utilization``) a list
over the bitrates. Every batch is padded to one length and scored on each
utterance's true length, so the scores do not depend on the batch size.
``--data_parallel`` copies the model onto every visible card (one process;
with ``--device cpu``, the CPU alone) and splits each batch's rows over
them where they divide evenly.
"""

from __future__ import annotations

import argparse
import json
import os

from ..metrics import (HAVE_PESQ, PESQ, SISDR, STOI, EntropyCounter,
                       MelSpectrogramDistance)
from ..parallel import Replicas
from ..train.data import make_dataloader
from ..train.evaluate import eval_epoch
from ..utils.config import read_yaml
from .compress import load_model

__all__ = ["parse_args", "run"]


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="esc_tpu_torch.cli.test")
    p.add_argument("--eval_folder_path", type=str, required=True)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--model_path", type=str, required=True,
                   help="folder with model configuration and checkpoint")
    p.add_argument("--save_path", type=str, default=None,
                   help="folder to save test statistics")
    p.add_argument("--num_streams", type=int, default=None,
                   help="evaluate a single bitrate instead of the sweep")
    p.add_argument("--data_parallel", action="store_true",
                   help="split eval batches over every visible card")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "PyTorch versions of the kernels)")
    p.add_argument("--dtype", type=str, default="float32",
                   choices=("float32", "bfloat16"),
                   help="compute dtype (bfloat16 is the bf16 serving mode)")
    return p.parse_args(argv)


def run(args) -> dict:
    model = load_model(args.model_path, device=args.device, dtype=args.dtype)
    eval_loader = make_dataloader(args.eval_folder_path, args.batch_size,
                                  shuffle=False, pad_eval=True,
                                  pad_fn=model.pad_length)
    metric_funcs = {"PESQ": PESQ(), "MelDistance": MelSpectrogramDistance(),
                    "SISDR": SISDR(), "STOI": STOI()}
    if not HAVE_PESQ:
        print("NOTE: PESQ scored by the numpy P.862.2 model "
              "(esc_tpu_torch/metrics_pesq.py): the `pesq` C library does "
              "not import. STOI is reported beside it.")
    cfg = read_yaml(os.path.join(args.model_path, "config.yaml"))["model"]
    e_counter = EntropyCounter(cfg["codebook_size"],
                               num_streams=cfg["max_streams"],
                               num_groups=cfg.get("group_size", 3))
    dp = Replicas.visible(model.device) if args.data_parallel else None
    if dp is not None:
        print(f"Evaluating on {dp.num_devices} device(s): "
              f"{', '.join(map(str, dp.devices))}")
    performances = eval_epoch(model, eval_loader, metric_funcs, e_counter,
                              bps_per_stream=1.5,
                              num_streams=args.num_streams, verbose=True,
                              dp=dp)
    save_path = args.save_path or args.model_path
    os.makedirs(save_path, exist_ok=True)
    with open(os.path.join(save_path, "perf_stats.json"), "w") as f:
        json.dump(performances, f, indent=2)
    print(f"Test statistics saved into {save_path}/perf_stats.json")
    return performances


if __name__ == "__main__":
    run(parse_args())
