"""Codec round-trip CLI (port of ``esc_tpu/cli/compress.py``).

    python -m esc_tpu_torch.cli.compress \
        --input audio.wav --save_path ./output \
        --model_path ./esc9kbps --num_streams 6

Writes ``decoded_{kbps}kbps_{name}.wav``, the codes as
``encoded_{kbps}kbps_{name}.npy`` and the ``.escb`` stream (version 2, range
coded, where that is smaller; else version 1, bit-packed). ``model_path``
holds ``config.yaml`` (any of the four codecs: its ``model_name``) and,
optionally, weights, taken from the first of ``model.pth``, ``best.pth``
(torch state dicts with the reference's keys), ``model.ckpt``,
``best.ckpt``, ``checkpoint.ckpt``, ``pretrained.ckpt`` (flax checkpoints,
with a conv codec's BatchNorm statistics) that exists; without one the
model is randomly initialised from ``--seed``. ``--dtype bfloat16`` is the bf16
serving mode; ``--chunk_seconds`` encodes and decodes in chunks of that
length, in constant memory.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np
import torch

from ..checkpoint import load_model_state
from ..io import load_wav, save_wav
from ..models import Codec, make_model
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
                   help="folder with config.yaml and optional weights "
                        "(model.pth, best.pth or a .ckpt)")
    p.add_argument("--num_streams", type=int, default=6,
                   help="number of transmitted streams in encoding")
    p.add_argument("--chunk_seconds", type=float, default=None,
                   help="constant-memory chunked inference for long files "
                        "(window-grid-aligned chunks + margins)")
    p.add_argument("--dtype", type=str, default="float32",
                   choices=("float32", "bfloat16"),
                   help="compute dtype; bfloat16 is the bf16 serving mode "
                        "(params stay float32)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "PyTorch versions of the kernels)")
    p.add_argument("--seed", type=int, default=0,
                   help="init seed when model_path holds no weights")
    return p.parse_args(argv)


# the weights load_model looks for, in order (esc_tpu/cli/compress.py:66-67)
CANDIDATES = ("model.pth", "best.pth", "model.ckpt", "best.ckpt",
              "checkpoint.ckpt", "pretrained.ckpt")


def load_model(model_path: str, seed: int = 0,
               device: Optional[str] = None, dtype: str = "float32") -> Codec:
    """Build the codec that ``{model_path}/config.yaml`` names (its
    ``model_name``, ``csvq+swinT`` where it names none) and load the first
    of :data:`CANDIDATES` that exists: a ``.pth`` (a state dict, or a
    reference checkpoint holding one under ``model_state_dict``) or a
    ``.ckpt`` written by the JAX package."""
    cfg = read_yaml(os.path.join(model_path, "config.yaml"))
    model = make_model(cfg["model"], cfg.get("model_name", "csvq+swinT"),
                       seed=seed, device=device, dtype=dtype)
    for cand in CANDIDATES:
        path = os.path.join(model_path, cand)
        if not os.path.exists(path):
            continue
        if cand.endswith(".pth"):
            ckp = torch.load(path, map_location="cpu", weights_only=True)
            model.load_state_dict(ckp.get("model_state_dict", ckp))
        else:
            model.load_state_dict(load_model_state(path))
        print(f"loaded weights from {path}")
        return model
    print(f"WARNING: no checkpoint found under {model_path}; "
          f"using random initialization (seed {seed})")
    return model


def compress_file(model: Codec, wav_path: str, out_dir: str,
                  num_streams: int = 6,
                  chunk_seconds: Optional[float] = None) -> dict:
    """Encode and decode one WAV file with a built model (in chunks of
    ``chunk_seconds`` where given); write the decoded WAV, the ``.npy``
    codes and the ``.escb`` stream into ``out_dir``. Returns their paths
    and the codes (numpy)."""
    x = load_wav(wav_path)[None, :]
    if chunk_seconds:
        codes, feat_shape = model.encode_chunked(
            x, num_streams=num_streams, chunk_seconds=chunk_seconds)
        recon = model.decode_chunked(codes, feat_shape,
                                     chunk_seconds=chunk_seconds)
    else:
        codes, feat_shape, recon = model.roundtrip(x,
                                                   num_streams=num_streams)
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
    model = load_model(args.model_path, seed=args.seed, device=args.device,
                       dtype=args.dtype)
    compress_file(model, args.input, args.save_path, args.num_streams,
                  args.chunk_seconds)
    print(f"compression outputs saved into {args.save_path}")


if __name__ == "__main__":
    main(parse_args())
