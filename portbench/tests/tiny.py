"""Tiny sizes of the benchmark's cells, for runs on the CPU.

The cells' own configurations at small widths (the layout of ESC-Base, a
64-entry codebook), the discriminator with two periods and two FFT sizes,
and each traffic mix with short clips and few units. On the CPU the port
runs its kernels' plain versions."""

import json

import torch

from portbench import run as R

TINY_MODEL = dict(in_dim=2, in_freq=192, h_dims=[12, 12, 16, 16, 24, 32],
                  max_streams=6, win_len=20, hop_len=5, sr=16000,
                  patch_size=[3, 2], swin_heads=[2, 2, 2, 2, 2],
                  swin_depth=2, window_size=4, mlp_ratio=4.0, overlap=2,
                  group_size=3, codebook_size=64,
                  codebook_dims=[8, 8, 8, 8, 8, 8], l2norm=True,
                  backbone="transformer")
SEED = 2 ** 31 + 12345          # larger than 32 signed bits hold



def tiny_cell(workload: str):
    """(bench, config, traffic) of ``workload`` at the tiny sizes."""
    bench = R.load_bench()
    cell = R.cell_of(bench, workload)
    with open(R.BENCH_DIR / "configs" / f"{cell['config']}.json") as f:
        config = json.load(f)
    with open(R.BENCH_DIR / "traffic" / f"{cell['traffic']}.json") as f:
        traffic = json.load(f)
    config["model"] = dict(TINY_MODEL)
    if "discriminator" in config:
        config["discriminator"].update(periods=[2, 3], fft_sizes=[512, 256])
    if traffic["driver"] == "serve_batch":
        traffic.update(batch=2, length=7920, pool=2, check=2, trace_units=2)
    elif traffic["driver"] == "serve_single":
        traffic.update(lengths=[3120, 7920], per_length=2,
                       check_per_length=2, trace_units=4, warm_blocks=1)
    elif traffic["driver"] == "train":
        traffic.update(batch=2, length=4720, trace_units=1)
    return bench, config, traffic


def run_tiny(workload: str, trace: bool = False, seconds: float = 0.5):
    """Run ``workload`` at the tiny sizes on the CPU: (run, metrics)."""
    torch.set_num_threads(2)
    bench, config, traffic = tiny_cell(workload)
    return R.execute(bench, workload, SEED, seconds, trace, device="cpu",
                     config=config, traffic=traffic)
