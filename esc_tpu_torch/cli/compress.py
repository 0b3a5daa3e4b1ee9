"""Codec round-trip CLI (port of ``esc_tpu/cli/compress.py``).

    python -m esc_tpu_torch.cli.compress \
        --input audio.wav --save_path ./output \
        --model_path ./esc9kbps --num_streams 6

Writes ``decoded_{kbps}kbps_{name}.wav``, the codes as
``encoded_{kbps}kbps_{name}.npy`` and the bit-packed ``.escb`` v1 stream.
``model_path`` holds ``config.yaml`` and, optionally, a torch state dict
with the reference's keys (``model.pth`` or ``best.pth``); without one the
model is randomly initialised from ``--seed``.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np
import torch

from ..io import load_wav, save_wav
from ..models import ESC, make_model
from ..utils.config import read_yaml
from .bitstream import pack_codes

__all__ = ["parse_args", "load_model", "compress_file", "main"]


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="esc_tpu_torch.cli.compress")
    p.add_argument("--input", type=str, required=True,
                   help="input 16kHz mono audio file to encode")
    p.add_argument("--save_path", type=str, default="./output",
                   help="folder to save codes and reconstructed audio")
    p.add_argument("--model_path", type=str, required=True,
                   help="folder with config.yaml and an optional model.pth")
    p.add_argument("--num_streams", type=int, default=6,
                   help="number of transmitted streams in encoding")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "PyTorch versions of the kernels)")
    p.add_argument("--seed", type=int, default=0,
                   help="init seed when model_path holds no weights")
    return p.parse_args(argv)


def load_model(model_path: str, seed: int = 0,
               device: Optional[str] = None) -> ESC:
    """Build the codec from ``{model_path}/config.yaml``; load
    ``model.pth`` / ``best.pth`` (a state dict, or a reference checkpoint
    holding one under ``model_state_dict``) when present."""
    cfg = read_yaml(os.path.join(model_path, "config.yaml"))
    model = make_model(cfg["model"], cfg.get("model_name", "csvq+swinT"),
                       seed=seed, device=device)
    for cand in ("model.pth", "best.pth"):
        path = os.path.join(model_path, cand)
        if os.path.exists(path):
            ckp = torch.load(path, map_location="cpu", weights_only=True)
            model.load_state_dict(ckp.get("model_state_dict", ckp))
            print(f"loaded weights from {path}")
            return model
    print(f"WARNING: no model.pth or best.pth under {model_path}; "
          f"using random initialization (seed {seed})")
    return model


def compress_file(model: ESC, wav_path: str, out_dir: str,
                  num_streams: int = 6) -> dict:
    """Encode and decode one WAV file with a built model; write the decoded
    WAV, the ``.npy`` codes and the ``.escb`` stream into ``out_dir``.
    Returns their paths and the codes (numpy)."""
    x = load_wav(wav_path)[None, :]
    codes, feat_shape, recon = model.roundtrip(x, num_streams=num_streams)
    codes = codes.cpu().numpy()
    fname = os.path.basename(wav_path)
    stem = fname.rsplit(".", 1)[0]
    kbps = num_streams * 1.5
    os.makedirs(out_dir, exist_ok=True)
    paths = {
        "wav": os.path.join(out_dir, f"decoded_{kbps}kbps_{fname}"),
        "npy": os.path.join(out_dir, f"encoded_{kbps}kbps_{stem}.npy"),
        "escb": os.path.join(out_dir, f"encoded_{kbps}kbps_{stem}.escb"),
    }
    save_wav(paths["wav"], recon[0].cpu().numpy())
    np.save(paths["npy"], codes)
    with open(paths["escb"], "wb") as f:
        f.write(pack_codes(codes, model.module.codebook_size, feat_shape))
    return {**paths, "codes": codes, "feat_shape": feat_shape}


def main(args) -> None:
    model = load_model(args.model_path, seed=args.seed, device=args.device)
    compress_file(model, args.input, args.save_path, args.num_streams)
    print(f"compression outputs saved into {args.save_path}")


if __name__ == "__main__":
    main(parse_args())
