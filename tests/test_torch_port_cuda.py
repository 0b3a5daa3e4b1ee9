"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``cuda`` and skips without a CUDA device. The
file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from esc_tpu_torch.models import ESC, make_model
from esc_tpu_torch.modules.scale import LayerNorm
from esc_tpu_torch.ops.kernels import (codebook_argmin, codebook_argmin_plain,
                                       layer_norm, layer_norm_plain, snake,
                                       snake_plain, window_attention,
                                       window_attention_plain)
from esc_tpu_torch.ops.kernels.codebook_argmin import launch_plan

pytestmark = pytest.mark.cuda

SMALL = dict(in_dim=2, in_freq=192, h_dims=[16, 16, 24, 24, 32, 64],
             max_streams=6, patch_size=[3, 2], swin_heads=[2, 2, 4, 4, 4],
             swin_depth=2, window_size=4, mlp_ratio=2.0, overlap=2,
             group_size=3, codebook_size=128, codebook_dims=[8] * 6,
             l2norm=True)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def rng():
    return np.random.default_rng(53)


def _normed(rng, shape, dev):
    a = rng.standard_normal(shape)
    return torch.tensor(a / np.linalg.norm(a, axis=-1, keepdims=True),
                        dtype=torch.float32, device=dev)


@pytest.mark.parametrize("d", [6, 8, 12, 16, 32])
def test_argmin_kernel_matches_plain(rng, cuda, d):
    z, cb = _normed(rng, (600, d), cuda), _normed(rng, (1024, d), cuda)
    n = codebook_argmin.launches
    ours = codebook_argmin(z, cb)
    torch.cuda.synchronize()
    assert codebook_argmin.launches == n + 1
    plain = codebook_argmin_plain(z, cb)
    # rows whose two nearest codewords lie within 1e-5 may flip with the
    # order of the fp32 sums; every other row must agree
    two = (torch.cdist(z.double(), cb.double()) ** 2).topk(
        2, largest=False).values
    near_tie = (two[:, 1] - two[:, 0]) <= 1e-5
    assert bool(((ours == plain) | near_tie).all())


def _near_tie(z, cb):
    """Rows whose two nearest codewords lie within 1e-5 (float64): only
    these may flip with the order of the fp32 sums."""
    dist = torch.cdist(z.double(), cb.double()) ** 2
    if cb.shape[0] < 2:
        return torch.zeros(z.shape[0], dtype=torch.bool, device=z.device)
    two = dist.topk(2, largest=False).values
    return (two[:, 1] - two[:, 0]) <= 1e-5


@pytest.mark.parametrize("d", list(range(6, 33)))
@pytest.mark.parametrize("K", [128, 1024])
@pytest.mark.parametrize("N", [1, 7, 4801])
def test_argmin_kernel_shapes(rng, cuda, N, K, d):
    z, cb = _normed(rng, (N, d), cuda), _normed(rng, (K, d), cuda)
    ours = codebook_argmin(z, cb)
    plain = codebook_argmin_plain(z, cb)
    assert bool(((ours == plain) | _near_tie(z, cb)).all())


@pytest.mark.parametrize("N", [600, 599, 661, 1201, 133])
def test_argmin_kernel_at_the_rvq_bottleneck(rng, cuda, N):
    """The RVQ ablations' bottleneck codebooks, 1024 x 8: 600 rows (4 clips
    of 3 s), and row counts that leave the plan's last block part empty."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    if N != 600:
        assert N % launch_plan(N, 1024, 8, sms).rows != 0
    z, cb = _normed(rng, (N, 8), cuda), _normed(rng, (1024, 8), cuda)
    n = codebook_argmin.launches
    ours = codebook_argmin(z, cb)
    torch.cuda.synchronize()
    assert codebook_argmin.launches == n + 1
    assert bool(((ours == codebook_argmin_plain(z, cb))
                 | _near_tie(z, cb)).all())


@pytest.mark.parametrize("K,d", [(7, 6), (1024, 8), (129, 9)])
def test_argmin_kernel_unaligned_codebook(rng, cuda, K, d):
    # a codebook whose bytes are not a multiple of 16, and one that starts
    # 4 bytes past a 16-byte boundary: the kernel copies what a bulk copy
    # cannot with plain loads
    z = _normed(rng, (600, d), cuda)
    flat = torch.zeros(K * d + 1, device=cuda)
    cb = flat[1:].view(K, d)
    cb.copy_(_normed(rng, (K, d), cuda))
    assert cb.data_ptr() % 16 != 0
    ours = codebook_argmin(z, cb)
    assert torch.equal(ours, codebook_argmin(z, cb.clone()))
    assert bool(((ours == codebook_argmin_plain(z, cb))
                 | _near_tie(z, cb)).all())


def test_argmin_kernel_ties_and_nan(rng, cuda):
    cb = torch.tensor(rng.standard_normal((1024, 8)), dtype=torch.float32,
                      device=cuda)
    cb[11] = cb[3]
    z = torch.cat([cb[[3, 11, 5]], torch.full((2, 8), float("nan"),
                                              device=cuda)])
    assert codebook_argmin(z, cb).tolist() == [3, 3, 5, 0, 0]
    assert codebook_argmin_plain(z, cb).tolist() == [3, 3, 5, 0, 0]


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    z = torch.zeros(4, 8, device=cuda)
    with pytest.raises(TypeError):
        codebook_argmin(z.double(), z.double())
    with pytest.raises(ValueError):
        codebook_argmin(z, torch.zeros(16, 8))          # codebook on the CPU
    with pytest.raises(ValueError):  # heads wider than MAX_HEAD_DIM
        window_attention(torch.zeros(2, 16, 3 * 257, device=cuda),
                         torch.zeros(1, 16, 16, device=cuda), None, 1, 1.0)
    with pytest.raises(ValueError):  # C not a multiple of the heads
        window_attention(torch.zeros(2, 16, 3 * 100, device=cuda),
                         torch.zeros(3, 16, 16, device=cuda), None, 3, 1.0)


@pytest.mark.parametrize("nh,hd", [(3, 15), (24, 16), (24, 8), (3, 24)])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernel_matches_plain(rng, cuda, nh, hd, masked, dtype):
    G, C = 300, nh * hd
    qkv = torch.tensor(rng.standard_normal((G, 16, 3 * C)),
                       dtype=torch.float32, device=cuda).to(dtype)
    bias = torch.tensor(rng.standard_normal((nh, 16, 16)),
                        dtype=torch.float32, device=cuda)
    mask = None
    if masked:
        mask = torch.tensor(np.where(rng.random((75, 16, 16)) > 0.5, 0.0,
                                     -100.0), dtype=torch.float32,
                            device=cuda)
    n = window_attention.launches
    ours = window_attention(qkv, bias, mask, nh, hd ** -0.5)
    torch.cuda.synchronize()
    assert window_attention.launches == n + 1
    tol = 2e-5 if dtype == torch.float32 else 5e-2
    torch.testing.assert_close(
        ours, window_attention_plain(qkv, bias, mask, nh, hd ** -0.5),
        atol=tol, rtol=1e-5 if dtype == torch.float32 else 5e-2)


# every window-attention geometry of ESC-Base serving (4 clips of 3 s,
# num_streams 1-6), then G that is no multiple of a grid or of the windows
# per tile
MAIN_PATH_ATTENTION = [(4800, 3, 15), (2400, 6, 12), (1200, 12, 8),
                       (600, 24, 6), (300, 24, 8), (300, 24, 16),
                       (600, 12, 12), (1200, 6, 16), (2400, 3, 24)]
RAGGED = [(1, 3, 15), (7, 6, 12), (301, 24, 16), (301, 3, 24), (7, 5, 7)]


@pytest.mark.parametrize("G,nh,hd", MAIN_PATH_ATTENTION + RAGGED)
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernel_geometries(rng, cuda, G, nh, hd, masked, dtype):
    C = nh * hd
    qkv = torch.tensor(rng.standard_normal((G, 16, 3 * C)),
                       dtype=torch.float32, device=cuda).to(dtype)
    bias = torch.tensor(rng.standard_normal((nh, 16, 16)),
                        dtype=torch.float32, device=cuda)
    mask = None
    if masked:
        nW = G // 4 if G % 4 == 0 else G
        mask = torch.tensor(np.where(rng.random((nW, 16, 16)) > 0.5, 0.0,
                                     -100.0), dtype=torch.float32,
                            device=cuda)
    ours = window_attention(qkv, bias, mask, nh, hd ** -0.5)
    tol = 2e-5 if dtype == torch.float32 else 5e-2
    torch.testing.assert_close(
        ours, window_attention_plain(qkv, bias, mask, nh, hd ** -0.5),
        atol=tol, rtol=1e-5 if dtype == torch.float32 else 5e-2)


# widths the all-heads kernel cannot hold (one window of all heads over
# shared memory, or heads wider than 32): heads split into groups
WIDE_ATTENTION = [(300, 24, 32), (300, 16, 64), (300, 8, 128), (7, 8, 128),
                  (301, 5, 40), (33, 2, 256), (9, 3, 33), (50, 7, 128)]


@pytest.mark.parametrize("G,nh,hd", WIDE_ATTENTION)
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernel_wide_heads(rng, cuda, G, nh, hd, masked, dtype):
    C = nh * hd
    qkv = torch.tensor(rng.standard_normal((G, 16, 3 * C)),
                       dtype=torch.float32, device=cuda).to(dtype)
    bias = torch.tensor(rng.standard_normal((nh, 16, 16)),
                        dtype=torch.float32, device=cuda)
    mask = None
    if masked:
        nW = G // 4 if G % 4 == 0 else G
        mask = torch.tensor(np.where(rng.random((nW, 16, 16)) > 0.5, 0.0,
                                     -100.0), dtype=torch.float32,
                            device=cuda)
    n = window_attention.launches
    ours = window_attention(qkv, bias, mask, nh, hd ** -0.5)
    torch.cuda.synchronize()
    assert window_attention.launches == n + 1
    tol = 2e-5 if dtype == torch.float32 else 5e-2
    torch.testing.assert_close(
        ours, window_attention_plain(qkv, bias, mask, nh, hd ** -0.5),
        atol=tol, rtol=1e-5 if dtype == torch.float32 else 5e-2)


# codebooks larger than a block's shared memory stream through it in
# K-tiles; K 4096 x d 8 fits whole
@pytest.mark.parametrize("N,K,d", [(600, 1024, 64), (600, 1024, 128),
                                   (7, 1024, 256), (4801, 4096, 8),
                                   (600, 1024, 57), (601, 1023, 65),
                                   (600, 8192, 8)])
def test_argmin_kernel_k_tiles(rng, cuda, N, K, d):
    z, cb = _normed(rng, (N, d), cuda), _normed(rng, (K, d), cuda)
    ours = codebook_argmin(z, cb)
    plain = codebook_argmin_plain(z, cb)
    assert bool(((ours == plain) | _near_tie(z, cb)).all())
    # an unaligned codebook takes plain loads in every tile
    flat = torch.zeros(K * d + 1, device=cuda)
    shifted = flat[1:].view(K, d)
    shifted.copy_(cb)
    assert torch.equal(codebook_argmin(z, shifted), ours)


def test_argmin_kernel_k_tiles_ties_and_nan(rng, cuda):
    # duplicates of a codeword in later tiles lose to the first; NaN -> 0
    cb = _normed(rng, (1024, 64), cuda)
    cb[700] = cb[3]
    cb[1000] = cb[3]
    z = torch.cat([cb[[3, 700, 1000, 999]],
                   torch.full((2, 64), float("nan"), device=cuda)])
    assert codebook_argmin(z, cb).tolist() == [3, 3, 3, 999, 0, 0]
    assert codebook_argmin_plain(z, cb).tolist() == [3, 3, 3, 999, 0, 0]


def test_attention_refuses_a_misaligned_qkv(cuda):
    G, nh, hd = 4, 3, 15
    flat = torch.zeros(G * 16 * 3 * nh * hd + 1, device=cuda)
    qkv = flat[1:].view(G, 16, 3 * nh * hd)
    assert qkv.is_contiguous() and qkv.data_ptr() % 16 != 0
    with pytest.raises(ValueError):
        window_attention(qkv, torch.zeros(nh, 16, 16, device=cuda), None, nh,
                         1.0)


def test_model_on_kernels_matches_plain_model(rng, cuda):
    x = (0.1 * rng.standard_normal((2, 15920))).astype(np.float32)
    model = ESC(seed=2, device=cuda, **SMALL)
    plain = ESC(seed=2, device=cuda, plain_ops=True, **SMALL)
    before = (codebook_argmin.launches, window_attention.launches,
              layer_norm.launches)
    codes, fs, recon = model.roundtrip(x, num_streams=6)
    torch.cuda.synchronize()
    assert codebook_argmin.launches > before[0]
    assert window_attention.launches > before[1]
    assert layer_norm.launches == before[2] + 79  # 50 in encode, 29 decode
    pcodes, _ = plain.encode(x, num_streams=6)
    assert float((pcodes != codes).float().mean()) <= 2e-3
    torch.testing.assert_close(plain.decode(codes, fs), recon, atol=5e-4,
                               rtol=0)


RVQ_SMALL = {k: v for k, v in SMALL.items() if k != "codebook_dims"}
ABLATION_SMALL = {
    "rvq+swinT": dict(RVQ_SMALL, codebook_dim=8, num_rvqs=6),
    "csvq+conv": dict(SMALL, backbone="convolution", kernel_size=[5, 2],
                      conv_depth=1),
    "rvq+conv": dict(RVQ_SMALL, backbone="convolution", kernel_size=[5, 2],
                     conv_depth=1, codebook_dim=8, num_rvqs=6),
}


@pytest.mark.parametrize("name", list(ABLATION_SMALL))
def test_ablation_models_on_kernels_match_plain(rng, cuda, name):
    x = (0.1 * rng.standard_normal((2, 15920))).astype(np.float32)
    model = make_model(ABLATION_SMALL[name], name, seed=2, device=cuda)
    plain = make_model(ABLATION_SMALL[name], name, seed=2, device=cuda,
                       plain_ops=True)
    before = (codebook_argmin.launches, window_attention.launches)
    codes, fs, recon = model.roundtrip(x, num_streams=3)
    torch.cuda.synchronize()
    assert codebook_argmin.launches == before[0] + 9    # 3 streams x 3
    assert (window_attention.launches > before[1]) == name.endswith("swinT")
    pcodes, _ = plain.encode(x, num_streams=3)
    assert codes.shape == pcodes.shape == (2, 3, 3, 50)
    assert float((pcodes != codes).float().mean()) <= 2e-3
    torch.testing.assert_close(plain.decode(codes, fs), recon, atol=5e-4,
                               rtol=0)


def test_bf16_model_on_the_card(rng, cuda):
    x = (0.1 * rng.standard_normal((2, 15920))).astype(np.float32)
    m32 = ESC(seed=2, device=cuda, **SMALL)
    m16 = ESC(seed=2, device=cuda, dtype=torch.bfloat16, **SMALL)
    plain16 = ESC(seed=2, device=cuda, dtype=torch.bfloat16, plain_ops=True,
                  **SMALL)
    assert {p.dtype for p in m16.module.parameters()} == {torch.float32}
    norms = [m for m in m16.module.modules() if isinstance(m, LayerNorm)]
    seen = []
    hooks = [m.register_forward_hook(
        lambda mod, args, out: seen.append((mod, args[0], out)))
        for m in norms]
    before = (window_attention.launches, layer_norm.launches)
    c16, fs, r16 = m16.roundtrip(x, num_streams=6)
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    assert window_attention.launches > before[0]
    assert layer_norm.launches == before[1] + len(seen) == before[1] + 79
    assert r16.dtype == torch.float32 and bool(torch.isfinite(r16).all())
    c32, _ = m32.encode(x, num_streams=6)
    agree = float((c16 == c32).float().mean())
    assert agree >= 0.8, f"bf16/fp32 code agreement {agree:.2%}"
    # LayerNorm stays fp32 in the bf16 mode: the kernel against
    # F.layer_norm on each of its calls' inputs
    for mod, inp, out in seen:
        assert inp.dtype == out.dtype == torch.float32
        torch.testing.assert_close(
            out, layer_norm_plain(inp, mod.weight, mod.bias, mod.eps),
            **LN_TOL)
    # the attention and argmin kernels against their plain versions, both
    # in bf16, on one LayerNorm (F.layer_norm): in bf16 a change of the
    # last bits anywhere flips codes by the percent (the plain model with
    # the LayerNorm kernel agrees with the plain model on 89-97 % of the
    # codes over 8 inputs on an H100), so the LayerNorm kernel is held
    # to F.layer_norm call by call above
    for m in norms:
        m.plain_ops = True
    c16, _ = m16.encode(x, num_streams=6)
    p16, _ = plain16.encode(x, num_streams=6)
    assert float((p16 == c16).float().mean()) >= 0.95


def test_chunked_codes_equal_the_plain_model(rng, cuda):
    x = (0.1 * rng.standard_normal((1, 60 * 320 - 80))).astype(np.float32)
    model = ESC(seed=2, device=cuda, **SMALL)
    plain = ESC(seed=2, device=cuda, plain_ops=True, **SMALL)
    kw = dict(chunk_seconds=0.5, margin_seconds=0.25)
    codes, fs = model.encode_chunked(x, num_streams=6, **kw)
    pcodes, pfs = plain.encode_chunked(x, num_streams=6, **kw)
    assert fs == pfs and codes.device.type == "cuda"
    assert float((pcodes != codes).float().mean()) <= 2e-3
    recon = model.decode_chunked(codes, fs, **kw)
    torch.testing.assert_close(plain.decode_chunked(codes, fs, **kw), recon,
                               atol=5e-4, rtol=0)


def test_stream_roundtrip_on_the_card(rng, cuda):
    from esc_tpu_torch.serving import stream_roundtrip

    model = ESC(seed=2, device=cuda, **SMALL)
    batches = [(0.1 * rng.standard_normal((2, 7920))).astype(np.float32)
               for _ in range(4)]
    outs = list(stream_roundtrip(model, batches, num_streams=6, depth=2))
    for x, (codes, recon) in zip(batches, outs):
        c, _, r = model.roundtrip(x, num_streams=6)
        assert np.array_equal(codes, c.cpu().numpy())
        assert np.array_equal(recon, r.cpu().numpy())


def test_range_coder_builds_and_round_trips(rng, cuda):
    # the host's C++ compiler builds native/rangecoder.cpp on this machine
    from esc_tpu_torch import rangecoder
    from esc_tpu_torch.cli.bitstream import pack_codes, unpack_codes

    path, _ = rangecoder.build()
    assert path.exists()
    probs = rng.dirichlet(np.full(1024, 0.03))
    codes = rng.choice(1024, (2, 6, 3, 300), p=probs).astype(np.int32)
    blob = pack_codes(codes, 1024, (2, 600))
    assert blob[4] == 2
    back, fs = unpack_codes(blob)
    assert np.array_equal(back, codes) and fs == (2, 600)


def test_eval_forward_on_kernels_matches_plain(rng, cuda):
    x = (0.1 * rng.standard_normal((2, 15920))).astype(np.float32)
    model = ESC(seed=2, device=cuda, **SMALL)
    plain = ESC(seed=2, device=cuda, plain_ops=True, **SMALL)
    for ns in (1, 6):
        before = (codebook_argmin.launches, window_attention.launches)
        out = model(x, num_streams=ns)
        torch.cuda.synchronize()
        assert codebook_argmin.launches > before[0]
        assert window_attention.launches > before[1]
        ref = plain(x, num_streams=ns)
        assert float((ref["codes"] != out["codes"]).float().mean()) <= 2e-3
        # the forward's waveform is the decode of its codes
        torch.testing.assert_close(plain.decode(out["codes"], model.feat_shape(
            x.shape[-1])), out["recon_audio"], atol=5e-4, rtol=0)
        assert bool(torch.isfinite(out["cm_loss"]).all())


def _train_step(model, opt, x, num_streams, freeze):
    from esc_tpu_torch.modules.losses import (complex_stft_loss,
                                              mel_spectrogram_loss)
    module = model.module
    module.train()
    out = module(x, num_streams, freeze)
    loss = (0.25 * out["cm_loss"] + out["cb_loss"]
            + 0.25 * mel_spectrogram_loss(out["raw_audio"], out["recon_audio"])
            + complex_stft_loss(out["raw_feat"], out["recon_feat"])).mean()
    opt.zero_grad()
    loss.backward()
    grads = [p.grad.clone() for p in module.parameters()]
    opt.step()
    module.eval()
    return loss.detach(), grads


@pytest.mark.parametrize("freeze", [True, False])
def test_train_step_on_the_card_launches_no_kernel(rng, cuda, freeze):
    # training runs the plain versions, as the JAX package does: a model
    # built on the kernels and one built on the plain versions take the
    # same step, up to the order of the card's atomic gradient sums
    from esc_tpu_torch.train.optim import AdamW, make_schedule

    x = torch.tensor(0.1 * rng.standard_normal((2, 7920)),
                     dtype=torch.float32, device=cuda)
    models = [ESC(seed=2, device=cuda, **SMALL),
              ESC(seed=2, device=cuda, plain_ops=True, **SMALL)]
    results = []
    for m in models:
        opt = AdamW(m.module.named_parameters(),
                    make_schedule("constant", 1e-4), clip_norm=0.5)
        before = (codebook_argmin.launches, window_attention.launches)
        loss, grads = _train_step(m, opt, x, 6, freeze)
        torch.cuda.synchronize()
        assert (codebook_argmin.launches, window_attention.launches) == before
        assert bool(torch.isfinite(loss))
        results.append((loss, grads))
    (l0, g0), (l1, g1) = results
    torch.testing.assert_close(l0, l1, rtol=1e-5, atol=0)
    num = sum(float(((a - b) ** 2).sum()) for a, b in zip(g0, g1))
    den = sum(float((b ** 2).sum()) for b in g1)
    assert (num / den) ** 0.5 < 1e-4


def test_metrics_on_the_card_equal_the_cpu(rng, cuda):
    from esc_tpu_torch import metrics

    x = (0.1 * rng.standard_normal((3, 9600))).astype(np.float32)
    y = (x + 0.05 * rng.standard_normal(x.shape)).astype(np.float32)
    lengths = np.array([9600, 700, 5001])
    xc, yc = torch.tensor(x, device=cuda), torch.tensor(y, device=cuda)
    for fn in (metrics.MelSpectrogramDistance(), metrics.SISDR()):
        for args in ((), (lengths,)):
            np.testing.assert_allclose(fn(xc, yc, *args), fn(x, y, *args),
                                       rtol=1e-4)
    codes = torch.tensor(rng.integers(0, 64, (3, 6, 3, 30)), device=cuda)
    a, b = metrics.EntropyCounter(64, 6, 3), metrics.EntropyCounter(64, 6, 3)
    a.update(codes, lengths=lengths, samples_per_code=320)
    b.update(codes.cpu(), lengths=lengths, samples_per_code=320)
    assert np.array_equal(a.counts, b.counts)


def test_discriminator_on_the_card_equals_the_cpu(rng, cuda):
    # feature maps and GAN losses at tests/test_torch_port_adv.py's bars
    # (rtol 2e-3, atol 2e-4), the MSD's resampling included
    from esc_tpu_torch.models.discriminator import (Discriminator,
                                                    init_discriminator)
    from esc_tpu_torch.modules.gan_loss import (discriminator_loss,
                                                generator_loss)

    cfg = dict(rates=(2,), periods=(2, 3), fft_sizes=(512, 256))
    cpu = init_discriminator(Discriminator(**cfg), 3)
    card = init_discriminator(Discriminator(**cfg), 3).to(cuda)
    fake = torch.tensor(0.3 * rng.standard_normal((2, 7920)),
                        dtype=torch.float32)
    real = torch.tensor(0.3 * rng.standard_normal((2, 7920)),
                        dtype=torch.float32)
    with torch.no_grad():
        for o, r in zip(card(fake.to(cuda)), cpu(fake)):
            for f, g in zip(o, r):
                torch.testing.assert_close(f.cpu(), g, rtol=2e-3, atol=2e-4)
        for ours, ref in ((discriminator_loss(card, fake.to(cuda),
                                              real.to(cuda)),
                           discriminator_loss(cpu, fake, real)),
                          (generator_loss(card, fake.to(cuda),
                                          real.to(cuda))[1],
                           generator_loss(cpu, fake, real)[1])):
            torch.testing.assert_close(ours.cpu(), ref, rtol=2e-3,
                                       atol=2e-4)


def test_adversarial_steps_on_the_card_are_reproducible(rng, cuda, tmp_path):
    # two trainers from one seed take two adversarial steps on one batch:
    # the same weights bit for bit (the steps run cuDNN's deterministic
    # algorithms), and neither kernel launches in a step
    import argparse

    from esc_tpu_torch.io import save_wav
    from esc_tpu_torch.train.trainer_adv import TrainerAdv

    for i in range(2):
        save_wav(str(tmp_path / f"clip_{i}.wav"),
                 (0.1 * rng.standard_normal(8000)).astype(np.float32))
    cfg = {"data": {"train_data_path": str(tmp_path),
                    "val_data_path": str(tmp_path), "num_workers": 0,
                    "train_bs_per_device": 2, "val_bs_per_device": 2},
           "model_name": "csvq+swinT", "model": dict(SMALL),
           "discriminator": {"rates": [], "periods": [2, 3],
                             "fft_sizes": [512, 256]},
           "loss": {"stft_weight": 0.0, "cm_weight": 0.25, "cb_weight": 1.0,
                    "mel_weight": 15.0, "gen_weight": 1.0,
                    "feat_weight": 2.0}}
    x = torch.tensor(0.1 * rng.standard_normal((2, 7920)),
                     dtype=torch.float32, device=cuda)
    weights = []
    for _ in range(2):
        args = argparse.Namespace(
            exp_name="card", lr=3e-4, num_epochs=1, num_pretraining_epochs=0,
            num_warmup_steps=0, val_metric="SISDR", scheduler_type="constant",
            dropout_rate=0.0, pretrain_ckp=None, log_steps=5,
            save_path=str(tmp_path / "out"), seed=4, resume=False,
            device="cuda")
        t = TrainerAdv(cfg, args)
        t.model, _, t.val_dl = t.load()
        before = (codebook_argmin.launches, window_attention.launches)
        for _ in range(2):
            aux = t.train_step(x, 6, False)
        torch.cuda.synchronize()
        assert (codebook_argmin.launches, window_attention.launches) == before
        assert all(bool(torch.isfinite(v)) for v in aux.values())
        weights.append([p.detach().clone() for p in
                        list(t.model.module.parameters())
                        + list(t.disc.parameters())])
    assert all(torch.equal(a, b) for a, b in zip(*weights))


# ------------------------------------------- the DAC and several cards
DAC_SMALL = dict(sample_rate=16000, encoder_dim=8, encoder_rates=[2, 4, 5, 8],
                 decoder_dim=96, decoder_rates=[8, 5, 4, 2], n_codebooks=4,
                 codebook_size=1024, codebook_dim=8)


@pytest.mark.parametrize("N", [1, 25, 47, 50, 200, 2400])
def test_argmin_kernel_at_the_dac_shapes(rng, cuda, N):
    """The DAC's 1024 x 8 cosine codebooks: a 1 s unpadded window gives
    tens of rows, 4 clips of 3 s 600, a padded 10 s file 500 a stage."""
    z, cb = _normed(rng, (N, 8), cuda), _normed(rng, (1024, 8), cuda)
    ours = codebook_argmin(z, cb)
    assert bool(((ours == codebook_argmin_plain(z, cb))
                 | _near_tie(z, cb)).all())


def test_dac_on_the_kernel_matches_plain(rng, cuda):
    """The DAC's searches, kernel against plain: at every stage of a
    forward, fed the same residual, the codes differ only on near ties;
    over the whole forward (4 clips of 3 s, 2,400 codes) on at most 0.2 %;
    compress launches the kernel once a stage and window, and the same
    codes decode alike."""
    from esc_tpu_torch.baselines.dac import DAC
    from esc_tpu_torch.modules.vq import _l2_normalize

    model = DAC(seed=3, device=cuda, **DAC_SMALL)
    plain = DAC(seed=3, device=cuda, plain_ops=True, **DAC_SMALL)
    x = (0.2 * rng.standard_normal((4, 3 * 16000))).astype(np.float32)
    with torch.no_grad():
        residual = model.module.encoder(torch.tensor(x, device=cuda)[:, None])
        for q in model.module.quantizer.quantizers:
            z_e = q.in_proj(residual)
            z = _l2_normalize(z_e.transpose(1, 2).reshape(-1, 8))
            cb = _l2_normalize(q.codebook.weight)
            ours, ref = codebook_argmin(z, cb), codebook_argmin_plain(z, cb)
            assert bool(((ours == ref) | _near_tie(z, cb)).all())
            residual = residual - q(residual)[0]
    codes = model(x)["codes"]
    mismatch = float((plain(x)["codes"] != codes).float().mean())
    assert codes.numel() == 2400 and mismatch <= 2e-3, f"{mismatch:.4%}"
    before = (codebook_argmin.launches, window_attention.launches)
    f = model.compress(x[0, :2 * 16000], win_duration=1.0)
    torch.cuda.synchronize()
    windows = f.codes.shape[-1] // f.chunk_length
    assert codebook_argmin.launches == before[0] + 4 * windows
    assert window_attention.launches == before[1]
    # the same codes decoded by both, before the loudness normalisation
    window = f.codes[..., :f.chunk_length]
    torch.testing.assert_close(plain.decode_codes(window, False),
                               model.decode_codes(window, False),
                               atol=5e-4, rtol=0)


def test_chunked_dp_over_every_card_equals_the_serial_pass(rng, cuda):
    from esc_tpu_torch.parallel import (Replicas, decode_chunked_dp,
                                        encode_chunked_dp)

    model = ESC(seed=2, device=cuda, **SMALL)
    x = (0.1 * rng.standard_normal((1, 60 * 320 - 80))).astype(np.float32)
    kw = dict(chunk_seconds=0.5, margin_seconds=0.25)
    dp = Replicas()
    assert dp.num_devices == torch.cuda.device_count()
    serial, fs = encode_chunked_dp(model, x, 6, **kw)
    spread, _ = encode_chunked_dp(model, x, 6, dp=dp, **kw)
    assert torch.equal(spread, serial)
    torch.testing.assert_close(decode_chunked_dp(model, spread, fs, dp=dp,
                                                 **kw),
                               decode_chunked_dp(model, serial, fs, **kw),
                               atol=0, rtol=0)


def test_kernels_on_a_second_card(rng, cuda):
    """Both kernels launched on cuda:1 while cuda:0 is current: the
    wrappers make the tensors' card current for the launch, and each card
    takes its own shared-memory attribute."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs a second CUDA device: this host has one card")
    dev = torch.device("cuda", 1)
    torch.cuda.set_device(0)
    for N, K, d in ((600, 1024, 8), (50, 1024, 8), (600, 1024, 64)):
        z, cb = _normed(rng, (N, d), dev), _normed(rng, (K, d), dev)
        ours = codebook_argmin(z, cb)
        assert ours.device == dev
        assert bool(((ours == codebook_argmin_plain(z, cb))
                     | _near_tie(z, cb)).all())
    for G, nh, hd in ((1200, 3, 15), (300, 16, 64)):
        qkv = torch.tensor(rng.standard_normal((G, 16, 3 * nh * hd)),
                           dtype=torch.float32, device=dev)
        bias = torch.tensor(rng.standard_normal((nh, 16, 16)),
                            dtype=torch.float32, device=dev)
        mask = torch.tensor(np.where(rng.random((G // 4, 16, 16)) > 0.5,
                                     0.0, -100.0), dtype=torch.float32,
                            device=dev)
        ours = window_attention(qkv, bias, mask, nh, hd ** -0.5)
        assert ours.device == dev
        torch.testing.assert_close(
            ours, window_attention_plain(qkv, bias, mask, nh, hd ** -0.5),
            atol=2e-5, rtol=1e-5)
    assert torch.cuda.current_device() == 0


# LayerNorm widths of ESC-Base and ESC-Large (h_dims and the patch merges'
# 2 h), and row counts from one row to the top scale's 16 x 64 x 300
LN_WIDTHS = [45, 72, 90, 96, 144, 192, 288, 384]
LN_ROWS = [1, 31, 4801, 307200]
# Both sides compute in fp32 from the same values; they differ in the order
# of the row sums (ATen's Welford against the kernel's mean, then squared
# deviations) and in rsqrt's last bits. Each moves a normalised value of
# size |z| <= 8 by a few units of its last place (1e-6) times sqrt(C) <= 20
# at most: 1e-5 on |y| + 1e-5 bounds both with room.
LN_TOL = dict(atol=1e-5, rtol=1e-5)


def _ln_inputs(rng, rows, C, dev):
    x = torch.tensor(rng.standard_normal((rows, C)) * 3 + 0.5,
                     dtype=torch.float32, device=dev)
    w = torch.tensor(rng.uniform(0.5, 1.5, C), dtype=torch.float32,
                     device=dev)
    b = torch.tensor(rng.standard_normal(C), dtype=torch.float32, device=dev)
    return x, w, b


@pytest.mark.parametrize("rows", LN_ROWS)
@pytest.mark.parametrize("C", LN_WIDTHS)
def test_layer_norm_kernel_matches_plain(rng, cuda, C, rows):
    x, w, b = _ln_inputs(rng, rows, C, cuda)
    n = layer_norm.launches
    with torch.no_grad():
        ours = layer_norm(x, w, b, 1e-6)
    torch.cuda.synchronize()
    assert layer_norm.launches == n + 1
    torch.testing.assert_close(ours, layer_norm_plain(x, w, b, 1e-6),
                               **LN_TOL)


@pytest.mark.parametrize("C", [1, 3, 5, 33, 1000, 4096])
def test_layer_norm_kernel_other_widths(rng, cuda, C):
    x, w, b = _ln_inputs(rng, 257, C, cuda)
    torch.testing.assert_close(layer_norm(x, w, b, 1e-6),
                               layer_norm_plain(x, w, b, 1e-6), **LN_TOL)


@pytest.mark.parametrize("C", [45, 90, 96])
def test_layer_norm_kernel_misaligned_rows(rng, cuda, C):
    """x 4 bytes past a 16-byte boundary: every tile's head and tail go 4
    bytes at a time and the output's 16-byte pieces do not line up with the
    buffer's; a 3-D batch of tokens, as the Swin blocks hand it."""
    x, w, b = _ln_inputs(rng, 4801, C, cuda)
    flat = torch.empty(x.numel() + 1, device=cuda)
    xs = flat[1:].view(4801, C)
    xs.copy_(x)
    assert xs.is_contiguous() and xs.data_ptr() % 16 != 0
    torch.testing.assert_close(layer_norm(xs, w, b, 1e-6),
                               layer_norm_plain(x, w, b, 1e-6), **LN_TOL)
    x3 = x[:4800].reshape(16, 300, C)
    torch.testing.assert_close(layer_norm(x3, w, b, 1e-6),
                               layer_norm_plain(x3, w, b, 1e-6), **LN_TOL)


def test_layer_norm_kernel_constant_rows_give_beta(rng, cuda):
    for C in LN_WIDTHS:
        _, w, b = _ln_inputs(rng, 1, C, cuda)
        x = torch.full((33, C), 2.5, device=cuda)
        assert torch.equal(layer_norm(x, w, b, 1e-6), b.expand(33, C))


def test_layer_norm_refusals(cuda):
    C = 45
    w, b = torch.ones(C, device=cuda), torch.zeros(C, device=cuda)
    x = torch.randn(10, C, device=cuda)
    with pytest.raises(TypeError):
        layer_norm(x.double(), w.double(), b.double(), 1e-6)
    with pytest.raises(ValueError):
        layer_norm(torch.randn(C, 10, device=cuda).t(), w, b, 1e-6)
    flat = torch.ones(C + 1, device=cuda)
    assert flat[1:].data_ptr() % 16 != 0
    with pytest.raises(ValueError):
        layer_norm(x, flat[1:], b, 1e-6)
    with pytest.raises(ValueError):
        layer_norm(torch.randn(10, 4097, device=cuda),
                   torch.ones(4097, device=cuda),
                   torch.zeros(4097, device=cuda), 1e-6)
    with pytest.raises(RuntimeError):
        layer_norm(x.clone().requires_grad_(), w, b, 1e-6)
    with torch.no_grad():
        layer_norm(x.clone().requires_grad_(), w, b, 1e-6)


# ------------------------------------------------------------- snake
# (C, T) of the 58 snakes of one padded roundtrip of 3 s at the DAC cell's
# configuration (portbench/metrics/snake_roofline.py::snake_calls), batch 16
SNAKE_CELL = [(64, 48000), (96, 47992), (128, 24000), (192, 23996),
              (256, 6000), (384, 5999), (512, 1200), (768, 1200),
              (1024, 150), (1536, 150)]
SNAKE_ALPHAS = ["one", "positive", "near_zero", "negative"]


def _snake_alpha(rng, C, kind, dev):
    a = {"one": np.ones(C),
         "positive": rng.uniform(0.05, 4.0, C),
         "near_zero": rng.choice([-1, 1], C) * 10.0 ** rng.uniform(-7, -3, C),
         "negative": -rng.uniform(0.05, 4.0, C)}[kind]
    return torch.tensor(a.reshape(1, C, 1), dtype=torch.float32, device=dev)


def _snake_input(rng, B, C, T, dev):
    """Normal values, every 997th 1e5 times larger: sinf's long range
    reduction past |alpha x| = 105,615."""
    x = torch.randn(B, C, T, generator=torch.Generator(dev).manual_seed(
        int(rng.integers(1 << 31))), device=dev) * 3
    flat = x.view(-1)
    flat[::997] *= 1e5
    return x


def _same_bits(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


@pytest.mark.parametrize("kind", SNAKE_ALPHAS)
@pytest.mark.parametrize("C,T", SNAKE_CELL)
def test_snake_kernel_is_plain_bit_for_bit_at_the_cell(rng, cuda, C, T,
                                                       kind):
    x = _snake_input(rng, 16, C, T, cuda)
    alpha = _snake_alpha(rng, C, kind, cuda)
    n = snake.launches
    ours = snake(x, alpha)
    torch.cuda.synchronize()
    assert snake.launches == n + 1
    assert _same_bits(ours, snake_plain(x, alpha))


@pytest.mark.parametrize("kind", SNAKE_ALPHAS)
@pytest.mark.parametrize("B,C,T", [(3, 7, 1), (2, 5, 3), (4, 33, 5999),
                                   (5, 1, 4097), (1, 1, 1), (1, 1, 3),
                                   (2, 3, 6)])
def test_snake_kernel_edge_shapes(rng, cuda, B, C, T, kind):
    """Rows shorter than a float4, a single channel, arrays shorter than
    one float4, and rows of odd length."""
    x = _snake_input(rng, B, C, T, cuda)
    alpha = _snake_alpha(rng, C, kind, cuda)
    assert _same_bits(snake(x, alpha), snake_plain(x, alpha))


@pytest.mark.parametrize("shift", [1, 2, 3])
@pytest.mark.parametrize("C,T", [(96, 47992), (1536, 150), (7, 3)])
def test_snake_kernel_misaligned_start(rng, cuda, C, T, shift):
    """x ``shift`` floats past a 16-byte boundary (a view into a larger
    buffer), the output aligned: the kernel takes each element alone."""
    x = _snake_input(rng, 2, C, T, cuda)
    flat = torch.empty(x.numel() + shift, device=cuda)
    xs = flat[shift:].view(2, C, T)
    xs.copy_(x)
    assert xs.is_contiguous() and xs.data_ptr() % 16 != 0
    alpha = _snake_alpha(rng, C, "positive", cuda)
    ours = snake(xs, alpha)
    assert ours.data_ptr() % 16 == 0
    assert _same_bits(ours, snake_plain(x, alpha))


def test_snake_refusals(cuda):
    x = torch.randn(2, 4, 10, device=cuda)
    alpha = torch.ones(1, 4, 1, device=cuda)
    n = snake.launches
    with pytest.raises(TypeError):
        snake(x.double(), alpha.double())
    with pytest.raises(ValueError):
        snake(x.transpose(1, 2).contiguous().transpose(1, 2), alpha)
    with pytest.raises(ValueError):
        snake(x, torch.ones(1, 5, 1, device=cuda))
    with pytest.raises(ValueError):
        snake(x, torch.ones(4, device=cuda))
    with pytest.raises(RuntimeError):
        snake(x.clone().requires_grad_(), alpha)
    with pytest.raises(RuntimeError):
        snake(x, alpha.clone().requires_grad_())
    assert snake.launches == n
    with torch.no_grad():
        snake(x.clone().requires_grad_(), alpha.clone().requires_grad_())
    assert snake.launches == n + 1


def _published_dac(cuda, **kw):
    from esc_tpu_torch.baselines.dac import DAC
    from esc_tpu_torch.utils.config import read_yaml

    cfg = read_yaml(str(Path(__file__).resolve().parents[1] / "configs"
                        / "dac" / "16khz_dns_9k.yml"))["DAC"]
    return DAC(seed=5, device=cuda, **cfg, **kw)


def test_dac_roundtrip_of_the_cell_launches_58_snakes(rng, cuda):
    """One encode_codes + decode_codes of 16 x 48,000 samples: 29 snakes in
    the encoder, 29 in the decoder, each one launch; codes and waveform
    bit for bit those of the same model with plain snakes (the same argmin
    kernel on both sides)."""
    from esc_tpu_torch.baselines.dac.layers import Snake1d

    model = _published_dac(cuda)
    plain_snakes = _published_dac(cuda)
    for m in plain_snakes.module.modules():
        if isinstance(m, Snake1d):
            m.plain_ops = True
    x = (0.2 * rng.standard_normal((16, 48000))).astype(np.float32)
    n = snake.launches
    codes = model.encode_codes(x)
    wave = model.decode_codes(codes)
    torch.cuda.synchronize()
    assert snake.launches == n + 58
    pcodes = plain_snakes.encode_codes(x)
    assert snake.launches == n + 58
    assert torch.equal(codes, pcodes)
    assert _same_bits(wave, plain_snakes.decode_codes(codes))


def test_dac_training_and_plain_ops_launch_no_snake(rng, cuda):
    from esc_tpu_torch.baselines.dac.layers import Snake1d

    plain = _published_dac(cuda, plain_ops=True)
    assert all(m.plain_ops for m in plain.module.modules()
               if isinstance(m, Snake1d))
    x = torch.tensor((0.2 * rng.standard_normal((2, 16000)))
                     .astype(np.float32), device=cuda)
    n = snake.launches
    plain.encode_codes(x)
    model = _published_dac(cuda)
    model.module.train()
    out = model.module(x)
    out["audio"].abs().mean().backward()
    model.module.eval()
    with torch.enable_grad():
        model.module.encoder(x[:, None])
    torch.cuda.synchronize()
    assert snake.launches == n
