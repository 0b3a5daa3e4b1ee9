"""The DAC CLI: encode a WAV file to a ``.dac`` file and back (port of
``esc_tpu/baselines/dac/__main__.py``; reference: dac/__main__.py:9-36).

    python -m esc_tpu_torch.baselines.dac encode in.wav --output out.dac \\
        --model_path ./dac_ckpt [--config configs/dac/16khz_dns_9k.yml] \\
        [--n_quantizers 9] [--win_duration 1.0] [--device cuda]
    python -m esc_tpu_torch.baselines.dac decode out.dac --output recon.wav \\
        --model_path ./dac_ckpt

``--config`` is a YAML file with a ``DAC`` section (the 16 kHz 9 kbps model
where none is given). The weights are the first of ``best.ckpt``,
``latest.ckpt``, ``model.ckpt`` (flax checkpoints, as either package's
trainer writes them) and ``model.pth`` (a reference state dict) under
``--model_path``; without one the model is random from seed 0.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np
import torch

from ...checkpoint import load_model_state
from ...io import save_wav
from ...utils.config import read_yaml
from .model import DAC

__all__ = ["DEFAULT_CONFIG", "CANDIDATES", "build_model", "main"]

DEFAULT_CONFIG = {"sample_rate": 16000, "encoder_dim": 64,
                  "encoder_rates": [2, 4, 5, 8], "decoder_dim": 1536,
                  "decoder_rates": [8, 5, 4, 2], "n_codebooks": 18,
                  "codebook_size": 1024, "codebook_dim": 8,
                  "quantizer_dropout": 0.5}
CANDIDATES = ("best.ckpt", "latest.ckpt", "model.ckpt", "model.pth")


def build_model(model_path: Optional[str], config_path: Optional[str],
                device: Optional[str] = None) -> DAC:
    """The DAC of ``config_path``'s ``DAC`` section with the weights of the
    first of :data:`CANDIDATES` under ``model_path``."""
    cfg = read_yaml(config_path)["DAC"] if config_path else DEFAULT_CONFIG
    model = DAC(device=device, **cfg)
    if not model_path:
        return model
    for cand in CANDIDATES:
        path = os.path.join(model_path, cand)
        if not os.path.exists(path):
            continue
        if cand.endswith(".pth"):
            ckp = torch.load(path, map_location="cpu", weights_only=True)
            sd = ckp.get("state_dict", ckp.get("model_state_dict", ckp))
        else:
            sd = load_model_state(path)
        model.load_state_dict(sd)
        print(f"loaded {path}")
        return model
    print(f"WARNING: no checkpoint under {model_path}; random init")
    return model


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="esc_tpu_torch.baselines.dac")
    sub = p.add_subparsers(dest="cmd", required=True)
    for name in ("encode", "decode"):
        s = sub.add_parser(name)
        s.add_argument("input")
        s.add_argument("--output", required=True)
        s.add_argument("--model_path", default=None)
        s.add_argument("--config", default=None)
        s.add_argument("--device", default="cuda",
                       help="torch device (default cuda; cpu runs the "
                            "argmin's plain version)")
        if name == "encode":
            s.add_argument("--n_quantizers", type=int, default=None)
            s.add_argument("--win_duration", type=float, default=1.0)
    args = p.parse_args(argv)

    model = build_model(args.model_path, args.config, args.device)
    if args.cmd == "encode":
        f = model.compress(args.input, win_duration=args.win_duration,
                           n_quantizers=args.n_quantizers)
        path = f.save(args.output)
        kbps = (f.codes.shape[1] * np.log2(model.config["codebook_size"])
                * model.sample_rate / model.hop_length / 1000)
        print(f"encoded -> {path} ({kbps:.2f} kbps)")
    else:
        y = model.decompress(args.input)
        save_wav(args.output, y[0], model.sample_rate)
        print(f"decoded -> {args.output}")


if __name__ == "__main__":
    main()
