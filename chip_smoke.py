#!/usr/bin/env python3
"""Drive the PyTorch port (esc_tpu_torch) of ESC on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each ending with one line that carries its seconds:

0. card     the card's name and power limit (nvidia-smi), torch and CUDA
1. build    nvcc builds esc_tpu_torch/csrc/*.cu for sm_90a (first use)
2. kernels  each CUDA kernel against its plain PyTorch version, on the
            card, at the shapes ESC-Base serving gives it (4 clips of 3 s);
            kernel, plain and library-call times
3. main     ESC-Base at full width (random weights from seed 0): encode ->
            decode and roundtrip at num_streams 1, 3 and 6 and the compress
            CLI on one generated wav, with the kernels' launch counts; then
            the same model on the plain versions, codes and waveforms
            compared; the real-time factor
4. profile  device time by kernel over one roundtrip (torch.profiler)

The second-to-last line is the kernels' JSON summary, the last
{"ok": true, "device": {...}}. Any failed check raises: the script then
exits non-zero and prints no result, as it does without a CUDA device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# ESC-Base, configs/9kbps_esc_base.yaml, with the per-scale codebook dims
# of the committed checkpoints (8 at every scale)
ESC_BASE = dict(
    backbone="transformer", in_dim=2, in_freq=192,
    h_dims=[45, 72, 96, 144, 192, 384], max_streams=6, win_len=20,
    hop_len=5, sr=16000, patch_size=[3, 2], swin_heads=[3, 6, 12, 24, 24],
    swin_depth=2, window_size=4, mlp_ratio=4.0, overlap=2, group_size=3,
    codebook_size=1024, codebook_dims=[8] * 6, l2norm=True)
BATCH = 4
CLIP = 47920           # 3 s at 16 kHz after the eval set's 80-sample trim
STREAMS = (1, 3, 6)
SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FP32_FLOP_PER_S = 67e12    # H100 SXM, CUDA cores (both kernels run there)
CODE_MISMATCH_MAX = 2e-3   # tests/test_ref_parity.py:111-122
WAVE_ATOL = 5e-4
ATTN_TOL = {torch.float32: (2e-5, 1e-5), torch.bfloat16: (5e-2, 5e-2)}
NEAR_TIE = 1e-5            # float64 gap of the two nearest codewords


def phase(name: str, t0: float, msg: str = "") -> float:
    """Print the line that ends a phase, with its seconds; return now."""
    now = time.time()
    print(" ".join(filter(None, [f"[{name}]", msg, f"({now - t0:.2f} s)"])),
          flush=True)
    return now


def cuda_time_ms(fn, reps: int = 20) -> float:
    """Mean device time of ``fn()`` in ms, by CUDA events, after warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------ the main path's calls
def main_path_calls(cfg: dict, batch: int, length: int, num_streams: int):
    """The kernel calls of one ``roundtrip(x, num_streams)``: a list of
    argmin shapes (N, K, d) and of attention shapes (G, nh, hd, masked)."""
    hop = int(cfg["hop_len"] * cfg["sr"] * 1e-3)
    ws, depth = cfg["window_size"], cfg["swin_depth"]
    H = cfg["in_freq"] // cfg["patch_size"][0]
    W = (length // hop + 1) // cfg["patch_size"][1]
    h, heads = cfg["h_dims"], cfg["swin_heads"]
    attn = []

    def layer(Hl, C, nh):
        G = batch * (-(-Hl // ws)) * (-(-W // ws))
        attn.extend((G, nh, C // nh, i % 2 == 1) for i in range(depth))

    enc_H = [H]
    for _ in range(len(h) - 1):
        enc_H.append((enc_H[-1] + 1) // 2)
    layer(enc_H[0], h[0], heads[0])                 # encoder pre_nn
    for i in range(len(h) - 1):                     # encoder blocks
        layer(enc_H[i], h[i], heads[i])
    dec_h, dec_heads, dec_H = h[::-1], heads[::-1], enc_H[::-1]
    for i in range(num_streams - 2):                # decoder.encode's blocks
        layer(dec_H[i], dec_h[i], dec_heads[i])
    for i in range(len(h) - 1):                     # decoder.decode's blocks
        layer(dec_H[i], dec_h[i], dec_heads[i])
    layer(dec_H[-1], dec_h[-1], dec_heads[-1])      # post_nn
    n_rows = batch * W // cfg["overlap"]
    argmin = [(n_rows, cfg["codebook_size"], cfg["codebook_dims"][s])
              for s in range(num_streams) for _ in range(cfg["group_size"])]
    return argmin, attn


def _count(calls):
    out = {}
    for c in calls:
        out[c] = out.get(c, 0) + 1
    return out


# ------------------------------------------------------------- phase 2
def check_argmin(kern, rng, dev):
    """Exact codes but for near ties; returns the entry's numbers."""
    wrapper, plain = kern["codebook_argmin"]
    excused = checked = 0
    max_err = 0.0

    def normed(a):
        return a / np.linalg.norm(a, axis=-1, keepdims=True)

    for N, d in [(600, 8), (1200, 6), (1200, 8), (1200, 12), (1200, 16),
                 (1200, 32)]:
        z = torch.tensor(normed(rng.standard_normal((N, d))),
                         dtype=torch.float32, device=dev)
        cb = torch.tensor(normed(rng.standard_normal((1024, d))),
                          dtype=torch.float32, device=dev)
        ours, ref = wrapper(z, cb), plain(z, cb)
        dist = torch.cdist(z.double(), cb.double()) ** 2
        two = dist.topk(2, largest=False).values
        tie = (two[:, 1] - two[:, 0]) <= NEAR_TIE
        diff = ours != ref
        if bool((diff & ~tie).any()):
            raise RuntimeError(f"codebook_argmin N={N} d={d}: "
                               f"{int((diff & ~tie).sum())} rows differ")
        rows = torch.arange(N, device=dev)
        err = (dist[rows, ours.long()] - dist[rows, ref.long()]).abs().max()
        max_err = max(max_err, float(err))
        excused += int(diff.sum())
        checked += N
    cb = torch.tensor(rng.standard_normal((1024, 8)), dtype=torch.float32,
                      device=dev)
    cb[11] = cb[3]
    cb[700] = cb[3]
    z = cb[[3, 11, 700, 5]].clone()
    dup = wrapper(z, cb).tolist()
    if dup != [3, 3, 3, 5] or plain(z, cb).tolist() != dup:
        raise RuntimeError(f"codebook_argmin duplicate rows gave {dup}")
    z = torch.randn(6, 8, device=dev)
    z[[0, 4]] = float("nan")
    nan = wrapper(z, cb)
    if not torch.equal(nan, plain(z, cb)) or nan[0] != 0 or nan[4] != 0:
        raise RuntimeError(f"codebook_argmin all-NaN rows gave {nan.tolist()}")
    print(f"  codebook_argmin: {checked} rows at K=1024, d in 6..32: "
          f"{excused} differ, all near ties (float64 gap <= {NEAR_TIE}); "
          f"duplicate rows -> {dup}; all-NaN rows -> 0; max |dist diff| "
          f"{max_err:.3g}", flush=True)
    return max_err


def attention_inputs(rng, dev, G, nh, hd, masked, dtype):
    """Random qkv and bias; the mask has one entry per window of a clip,
    as the SW-MSA mask of the main path."""
    C, nW = nh * hd, G // BATCH
    qkv = torch.tensor(rng.standard_normal((G, 16, 3 * C)),
                       dtype=torch.float32, device=dev).to(dtype)
    bias = torch.tensor(rng.standard_normal((nh, 16, 16)),
                        dtype=torch.float32, device=dev)
    mask = None
    if masked:
        mask = torch.tensor(np.where(rng.random((nW, 16, 16)) > 0.5, 0.0,
                                     -100.0), dtype=torch.float32, device=dev)
    return qkv, bias, mask


def check_attention(kern, rng, dev, shapes):
    wrapper, plain = kern["window_attention"]
    max_err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for G, nh, hd in shapes:
        for masked in (False, True):
            for dtype in (torch.float32, torch.bfloat16):
                qkv, bias, mask = attention_inputs(rng, dev, G, nh, hd,
                                                   masked, dtype)
                ours = wrapper(qkv, bias, mask, nh, hd ** -0.5)
                ref = plain(qkv, bias, mask, nh, hd ** -0.5)
                atol, rtol = ATTN_TOL[dtype]
                torch.testing.assert_close(
                    ours, ref, atol=atol, rtol=rtol,
                    msg=lambda m: f"window_attention G={G} nh={nh} hd={hd} "
                                  f"masked={masked} {dtype}: {m}")
                max_err[dtype] = max(max_err[dtype],
                                     float((ours - ref).abs().max()))
    print(f"  window_attention: {len(shapes)} geometries x masked/unmasked "
          f"x f32/bf16 agree; max abs err f32 "
          f"{max_err[torch.float32]:.3g} (atol 2e-5), bf16 "
          f"{max_err[torch.bfloat16]:.3g} (atol 5e-2)", flush=True)
    return max_err[torch.float32]


def time_argmin(kern, rng, dev, calls):
    wrapper, plain = kern["codebook_argmin"]
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0.0,
           "flops": 0.0}
    for (N, K, d), n in _count(calls).items():
        z = torch.nn.functional.normalize(torch.randn(N, d, device=dev), dim=1)
        cb = torch.nn.functional.normalize(torch.randn(K, d, device=dev),
                                           dim=1)
        ms = cuda_time_ms(lambda: wrapper(z, cb))
        pms = cuda_time_ms(lambda: plain(z, cb))
        lms = cuda_time_ms(lambda: torch.cdist(z, cb).argmin(1))
        print(f"  codebook_argmin N={N} K={K} d={d} x{n}: kernel {ms:.4f} "
              f"ms, plain {pms:.4f} ms, cdist+argmin {lms:.4f} ms",
              flush=True)
        tot["ms"] += n * ms
        tot["plain_ms"] += n * pms
        tot["library_ms"] += n * lms
        tot["bytes"] += n * 4 * (N * d + K * d + N)
        tot["flops"] += n * (2 * N * K * d + 3 * N * K)
    return tot


def time_attention(kern, rng, dev, calls):
    wrapper, plain = kern["window_attention"]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0.0,
           "flops": 0.0}
    for (G, nh, hd, masked), n in _count(calls).items():
        qkv, bias, mask = attention_inputs(rng, dev, G, nh, hd, masked,
                                           torch.float32)
        scale = hd ** -0.5
        ms = cuda_time_ms(lambda: wrapper(qkv, bias, mask, nh, scale))
        pms = cuda_time_ms(lambda: plain(qkv, bias, mask, nh, scale))
        q, k, v = qkv.reshape(G, 16, 3, nh, hd).permute(2, 0, 3, 1,
                                                        4).contiguous()
        full = bias[None].expand(G, nh, 16, 16)
        if mask is not None:
            nW = mask.shape[0]
            full = (full.reshape(G // nW, nW, nh, 16, 16)
                    + mask[None, :, None]).reshape(G, nh, 16, 16)
        full = full.contiguous()
        lms = cuda_time_ms(lambda: sdpa(q, k, v, attn_mask=full,
                                        scale=scale))
        print(f"  window_attention G={G} nh={nh} hd={hd} "
              f"{'masked' if masked else 'unmasked'} x{n}: kernel "
              f"{ms:.4f} ms, plain {pms:.4f} ms, sdpa {lms:.4f} ms",
              flush=True)
        C = nh * hd
        tot["ms"] += n * ms
        tot["plain_ms"] += n * pms
        tot["library_ms"] += n * lms
        tot["bytes"] += n * 4 * (G * 16 * 4 * C + nh * 256
                                 + (mask.shape[0] * 256 if masked else 0))
        tot["flops"] += n * G * nh * (4 * 256 * hd + 5 * 256)
    return tot


# ------------------------------------------------------------- phase 3
def drive_main_path(model, x, compress_file, tmp):
    """The main path as a user drives it; returns what it produced."""
    out = {}
    for ns in STREAMS:
        codes, fs = model.encode(x, num_streams=ns)
        recon = model.decode(codes, fs)
        rc, rfs, rrecon = model.roundtrip(x, num_streams=ns)
        out[ns] = (codes, fs, recon, rc, rrecon)
    cli = compress_file(model, os.path.join(tmp, "clip.wav"),
                        os.path.join(tmp, "out"), num_streams=6)
    torch.cuda.synchronize()
    return out, cli


def check_main_path(model, plain_model, x, out, cli, tmp):
    from esc_tpu_torch.cli.bitstream import unpack_codes
    from esc_tpu_torch.io import load_wav

    L = x.shape[-1]
    for ns, (codes, fs, recon, rc, rrecon) in out.items():
        want = (BATCH, ns, ESC_BASE["group_size"],
                 fs[1] // ESC_BASE["overlap"])
        if tuple(codes.shape) != want or codes.dtype != torch.int32:
            raise RuntimeError(f"codes {tuple(codes.shape)} {codes.dtype}, "
                               f"expected {want} int32")
        if not (torch.equal(codes, rc) and torch.equal(recon, rrecon)):
            raise RuntimeError(f"ns={ns}: roundtrip differs from "
                               "encode + decode")
        if tuple(recon.shape) != (BATCH, L) or not bool(
                torch.isfinite(recon).all()):
            raise RuntimeError(f"ns={ns}: waveform {tuple(recon.shape)} "
                               "not finite or misshaped")
        if int(codes.min()) < 0 or \
                int(codes.max()) >= ESC_BASE["codebook_size"]:
            raise RuntimeError(f"ns={ns}: codes out of range")
        pcodes, pfs = plain_model.encode(x, num_streams=ns)
        mismatch = float((pcodes != codes).float().mean())
        if mismatch > CODE_MISMATCH_MAX or tuple(pfs) != tuple(fs):
            raise RuntimeError(f"ns={ns}: code mismatch {mismatch:.4%} "
                               f"against the plain versions")
        precon = plain_model.decode(codes, fs)
        err = float((precon - recon).abs().max())
        if err > WAVE_ATOL:
            raise RuntimeError(f"ns={ns}: waveform differs by {err:.3g}")
        print(f"  ns={ns}: codes {tuple(codes.shape)} mismatch vs plain "
              f"{mismatch:.4%} (<= 0.2%), same codes decoded: max abs "
              f"diff {err:.3g} (<= 5e-4)", flush=True)
    with open(cli["escb"], "rb") as f:
        blob_codes, fs = unpack_codes(f.read())
    wav = load_wav(os.path.join(tmp, "clip.wav"))
    direct, dfs = model.encode(wav[None], num_streams=6)
    if not (np.array_equal(blob_codes, np.load(cli["npy"]))
            and np.array_equal(blob_codes, direct.cpu().numpy())
            and tuple(fs) == tuple(dfs)):
        raise RuntimeError("compress CLI: .escb codes differ")
    print(f"  compress CLI: {os.path.getsize(cli['escb'])} B .escb unpacks "
          f"to the .npy codes {blob_codes.shape}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    t0 = time.time()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = phase("0 card", t0, f"torch {torch.__version__}, CUDA "
               f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    from esc_tpu_torch.cli.compress import compress_file
    from esc_tpu_torch.io import save_wav
    from esc_tpu_torch.models import make_model
    from esc_tpu_torch.ops.kernels import KERNELS, _build

    print("  " + " ".join(_build.nvcc_command(_build.library_path())),
          flush=True)
    path, built = _build.build()
    _build.library()
    t0 = phase("1 build", t0, f"{'built' if built else 'found'} "
               f"{os.path.relpath(path)}")

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    argmin_calls, attn_calls = main_path_calls(ESC_BASE, BATCH, CLIP, 6)
    attn_shapes = sorted({(G, nh, hd) for G, nh, hd, _ in attn_calls})
    argmin_err = check_argmin(KERNELS, rng, dev)
    attn_err = check_attention(KERNELS, rng, dev, attn_shapes)
    timing = {"codebook_argmin": time_argmin(KERNELS, rng, dev, argmin_calls),
              "window_attention": time_attention(KERNELS, rng, dev,
                                                 attn_calls)}
    t0 = phase("2 kernels", t0, "all kernels agree with their plain versions")

    model = make_model(ESC_BASE, seed=SEED, device=dev)
    plain_model = make_model(ESC_BASE, seed=SEED, device=dev, plain_ops=True)
    x = torch.tensor(0.1 * rng.standard_normal((BATCH, CLIP)),
                     dtype=torch.float32)
    with tempfile.TemporaryDirectory() as tmp:
        save_wav(os.path.join(tmp, "clip.wav"), 0.5 * x[0].numpy())
        model.roundtrip(x, num_streams=6)          # warm-up, not counted
        torch.cuda.synchronize()
        for wrapper, _ in KERNELS.values():
            wrapper.launches = 0
        out, cli = drive_main_path(model, x, compress_file, tmp)
        launches = {name: wrapper.launches
                    for name, (wrapper, _) in KERNELS.items()}
        print(f"  launches on the main path: {launches}", flush=True)
        if min(launches.values()) == 0:
            raise RuntimeError(f"a kernel never ran on the main path: "
                               f"{launches}")
        check_main_path(model, plain_model, x, out, cli, tmp)

    per_rt = {"codebook_argmin": len(argmin_calls),
              "window_attention": len(attn_calls)}
    for name in KERNELS:
        wrapper = KERNELS[name][0]
        wrapper.launches = 0
    model.roundtrip(x, num_streams=6)
    got = {name: w.launches for name, (w, _) in KERNELS.items()}
    if got != per_rt:
        raise RuntimeError(f"launches per roundtrip {got}, expected {per_rt}")
    print(f"  launches per roundtrip at ns=6: {got}", flush=True)
    audio_s = BATCH * CLIP / ESC_BASE["sr"]
    rtf = {}
    for label, m in (("kernels", model), ("plain", plain_model)):
        m.roundtrip(x, num_streams=6)
        torch.cuda.synchronize()
        reps = 10
        start = time.perf_counter()
        for _ in range(reps):
            m.roundtrip(x, num_streams=6)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - start) / reps
        rtf[label] = audio_s / wall
        print(f"  roundtrip ns=6, {BATCH} x 3 s on {label}: {wall * 1e3:.2f} "
              f"ms, real-time factor {rtf[label]:.1f}", flush=True)
    t0 = phase("3 main", t0, f"ESC-Base serving ok, real-time factor "
               f"{rtf['kernels']:.1f} (plain {rtf['plain']:.1f})")

    from torch.profiler import ProfilerActivity, profile
    model.roundtrip(x, num_streams=6)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        model.roundtrip(x, num_streams=6)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) is not None
              and "CUDA" in str(e.device_type)]
    dev_us = sum(e.self_device_time_total for e in events)
    if dev_us > 0:
        print(f"  one roundtrip: wall {wall * 1e3:.2f} ms, device busy "
              f"{dev_us / 1e3:.2f} ms ({dev_us / 1e3 / (wall * 1e3):.1%})",
              flush=True)
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
            print(f"    {e.self_device_time_total / 1e3:8.3f} ms "
                  f"x{e.count:<4d} {e.key[:90]}", flush=True)
    else:
        print("  profiler recorded no device time: not measured", flush=True)
    t0 = phase("4 profile", t0)

    summary = []
    for name, src, replaces, err in (
            ("codebook_argmin", "esc_tpu_torch/csrc/codebook_argmin.cu",
             "esc_tpu/ops/pallas/vq_kernels.py:56", argmin_err),
            ("window_attention", "esc_tpu_torch/csrc/window_attention.cu",
             "esc_tpu/ops/pallas/attention_kernels.py:131", attn_err)):
        tm = timing[name]
        b_ms, b_by = bound_ms(tm["bytes"], tm["flops"])
        summary.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err, "ms": tm["ms"], "plain_ms": tm["plain_ms"],
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": tm["library_ms"]})
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
