"""The port's snake route and launch plan, on the CPU.

``esc_tpu_torch.baselines.dac.layers.Snake1d`` runs the snake kernel
(``esc_tpu_torch/csrc/snake.cu``) outside training, ``plain_ops`` and
autograd; a CPU tensor takes the wrapper's plain version. The kernel itself
is held to the plain version bit for bit on a card by
``tests/test_torch_port_cuda.py``. Here: the plain version against
``esc_tpu``'s snake, the routing, the flag of a plain DAC, and the launch
plan: every element in exactly one place and every element's channel by
the kernel's divisions, at the DAC cell's shapes and at edge shapes.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esc_tpu.baselines.dac.layers import snake as jax_snake
from esc_tpu_torch.baselines.dac import DAC
from esc_tpu_torch.baselines.dac import layers
from esc_tpu_torch.baselines.dac.layers import Snake1d
from esc_tpu_torch.ops.kernels import KERNELS, snake, snake_plain
from tests.test_torch_port_conv import one_torch_thread  # noqa: F401

# the module, not the wrapper the package exports under the same name
sn = importlib.import_module("esc_tpu_torch.ops.kernels.snake")

NUM_SMS = 132           # an H100 SXM
# (C, T) of the DAC cell's snakes at batch 16 (portbench/metrics/
# snake_roofline.py::snake_calls of the cell's configuration and traffic)
CELL = [(64, 48000), (96, 47992), (128, 24000), (192, 23996), (256, 6000),
        (384, 5999), (512, 1200), (768, 1200), (1024, 150), (1536, 150)]
EDGE = [(16, 64, 1), (16, 64, 3), (16, 384, 5999), (16, 1, 48000),
        (1, 1, 1), (1, 1, 3), (2, 1, 5), (3, 7, 1)]
SHAPES = [(16, C, T) for C, T in CELL] + EDGE
DAC_SMALL = dict(sample_rate=16000, encoder_dim=8, encoder_rates=[2, 4, 5, 8],
                 decoder_dim=96, decoder_rates=[8, 5, 4, 2], n_codebooks=4,
                 codebook_size=1024, codebook_dim=8)


@pytest.mark.parametrize("kind", ["one", "positive", "negative"])
def test_plain_is_esc_tpus_snake(kind):
    rng = np.random.default_rng(len(kind))
    B, C, T = 3, 6, 50
    x = (rng.standard_normal((B, C, T)) * 3).astype(np.float32)
    a = {"one": np.ones(C), "positive": rng.uniform(0.05, 4, C),
         "negative": -rng.uniform(0.05, 4, C)}[kind].astype(np.float32)
    ours = snake_plain(torch.tensor(x), torch.tensor(a.reshape(1, C, 1)))
    # esc_tpu is channels-last: (B, T, C), alpha (1, 1, C)
    want = np.asarray(jax_snake(jnp.asarray(x.transpose(0, 2, 1)),
                                jnp.asarray(a.reshape(1, 1, C))))
    np.testing.assert_allclose(ours.numpy(), want.transpose(0, 2, 1),
                               rtol=1e-6, atol=1e-6)
    # the float the kernel writes as 1e-9f is the one ATen rounds the
    # double 1e-9 to
    assert torch.tensor(1e-9, dtype=torch.float64).float().item() \
        == float(np.float32("1e-9"))


def test_wrapper_sends_cpu_tensors_to_the_plain_version():
    x = torch.randn(2, 5, 17)
    alpha = torch.rand(1, 5, 1) + 0.5
    n = snake.launches
    assert torch.equal(snake(x, alpha), snake_plain(x, alpha))
    assert snake.launches == n
    assert KERNELS["snake"] == (snake, snake_plain)
    assert isinstance(snake.launches, int)


@pytest.mark.parametrize("mode", ["eval", "train", "plain_ops", "autograd"])
def test_snake1d_routing(monkeypatch, mode):
    """Eval mode outside autograd takes the kernel's wrapper; training,
    plain_ops and a call autograd records (an input that requires grad)
    take the plain expression, with its gradients."""
    calls = []

    def counting(x, alpha):
        calls.append(tuple(x.shape))
        return snake_plain(x, alpha)

    monkeypatch.setattr(layers, "snake_kernel", counting)
    m = Snake1d(4)
    with torch.no_grad():
        m.alpha.copy_(torch.tensor([0.5, 1.0, 2.0, -1.5]).reshape(1, 4, 1))
    m.train(mode == "train")
    m.plain_ops = mode == "plain_ops"
    x = torch.randn(2, 4, 9)
    if mode == "eval":
        with torch.no_grad():
            assert torch.equal(m(x), snake_plain(x, m.alpha))
            # a strided input reaches the kernel as a contiguous copy
            xt = torch.randn(2, 9, 4).transpose(1, 2)
            assert torch.equal(m(xt), snake_plain(xt, m.alpha))
        assert calls == [(2, 4, 9), (2, 4, 9)]
        return
    xa = x.clone().requires_grad_()
    y = m(xa)
    assert calls == []
    assert torch.equal(y, snake_plain(x, m.alpha))
    y.sum().backward()
    assert xa.grad is not None and m.alpha.grad is not None


def test_eval_mode_with_grad_enabled_stays_plain(monkeypatch):
    """alpha is a parameter: an eval call with grad enabled is recorded
    and stays plain; with alpha frozen nothing is recorded."""
    calls = []

    def counting(x, alpha):
        calls.append(tuple(x.shape))
        return snake_plain(x, alpha)

    monkeypatch.setattr(layers, "snake_kernel", counting)
    m = Snake1d(3).eval()
    x = torch.randn(1, 3, 5)
    y = m(x)
    assert y.requires_grad and calls == []
    assert torch.equal(y, snake_plain(x, m.alpha))
    m.alpha.requires_grad_(False)
    assert torch.equal(m(x), snake_plain(x, m.alpha))
    assert calls == [(1, 3, 5)]


@pytest.mark.parametrize("plain_ops", [False, True])
def test_dac_plain_ops_sets_every_snake(plain_ops):
    model = DAC(seed=0, device="cpu", plain_ops=plain_ops, **DAC_SMALL)
    snakes = [m for m in model.module.modules() if isinstance(m, Snake1d)]
    assert len(snakes) == 58
    assert all(m.plain_ops is plain_ops for m in snakes)


def _body(n, head):
    """(float4s of the body, elements of the tail) for a start ``head``
    floats before a 16-byte boundary, as the kernel splits it."""
    head = min(n, head)
    n4 = (n - head) // 4
    return n4, n - head - 4 * n4


@pytest.mark.parametrize("B,C,T", SHAPES)
def test_launch_plan_covers_every_element_once(B, C, T):
    n = B * C * T
    p = sn.launch_plan(B * C, T, NUM_SMS)
    assert p.threads == sn.THREADS and p.unroll == sn.UNROLL
    # at most the blocks the card holds at once; spans of whole lines
    assert 1 <= p.grid <= NUM_SMS * sn.BLOCKS_PER_SM
    assert p.per_block >= sn.LINE and p.per_block % sn.LINE == 0
    # every block has work; the spans reach the body's end
    work = max(n // 4, 1)
    assert (p.grid - 1) * p.per_block < work <= p.grid * p.per_block
    # a large call fills the card
    if work >= NUM_SMS * sn.BLOCKS_PER_SM * sn.THREADS * sn.UNROLL:
        assert p.grid > (NUM_SMS * sn.BLOCKS_PER_SM) * 0.9
    for head in range(4):
        n4, tail = _body(n, head)
        assert 0 <= tail < 4 and min(n, head) + 4 * n4 + tail == n
        seen = np.zeros(n4 + 1, np.int64)
        for b in range(p.grid):
            start = b * p.per_block
            end = min(start + p.per_block, n4)
            if start < end:
                seen[start] += 1
                seen[end] -= 1
        assert (np.cumsum(seen)[:n4] == 1).all()
    assert list(sn._launch_args(B * C, T, C, NUM_SMS)) == [
        n, T, C, p.threads, p.unroll, p.grid, p.per_block,
        *sn.divider(T), *sn.divider(C)]


@pytest.mark.parametrize("B,C,T", SHAPES)
def test_channel_of_every_row_end_by_the_kernels_divisions(B, C, T):
    """The first and last four elements of every row, and every float4 of
    the first rows: (i // T) % C by the kernel's multiply-high divisions."""
    n = B * C * T
    rows = np.arange(B * C, dtype=np.uint64)
    i = (rows[:, None] * np.uint64(T)
         + np.array([0, 1, 2, 3, T - 4, T - 3, T - 2, T - 1],
                    dtype=np.int64).clip(0, T - 1).astype(np.uint64))
    i = np.concatenate([i.ravel(), np.arange(0, min(n, 40000),
                                             dtype=np.uint64)])
    mt, st = sn.divider(T)
    mc, sc = sn.divider(C)

    def div(v, mul, shift):
        return (((v * np.uint64(mul)) >> np.uint64(32)) + v) >> np.uint64(
            shift)

    r = div(i, mt, st)
    assert (r == i // np.uint64(T)).all()
    c = r - div(r, mc, sc) * np.uint64(C)
    assert (c == (i // np.uint64(T)) % np.uint64(C)).all()


@pytest.mark.parametrize("d", [1, 2, 3, 5, 7, 150, 1200, 1536, 5999, 23996,
                               47992, 48000, 2 ** 20 + 1, 2 ** 31 - 1])
def test_divider_over_the_range(d):
    mul, shift = sn.divider(d)
    assert 0 < mul < 2 ** 32 and 0 <= shift <= 31
    rng = np.random.default_rng(d)
    for v in [0, 1, d - 1, d, d + 1, 2 ** 31 - 1, 2 ** 31 - 2,
              *rng.integers(0, 2 ** 31, 200).tolist()]:
        if v >= 0:       # the kernel's quotient() on 32-bit words
            assert (((v * mul) >> 32) + v) >> shift == v // d, (v, d)


def test_plan_refuses_what_the_kernel_does_not_take():
    for rows, T in ((0, 10), (10, 0), (2 ** 16, 2 ** 15)):
        with pytest.raises(ValueError):
            sn.launch_plan(rows, T, NUM_SMS)
    with pytest.raises(ValueError):
        sn.divider(0)


@pytest.mark.parametrize("B,L", [(2, 3200), (1, 16000)])
def test_chip_smoke_predicts_the_dac_snakes(B, L):
    """chip_smoke.py's snake calls of a DAC roundtrip: what forward hooks on
    the snakes of encode_codes + decode_codes see, in order; at the DAC
    cell, the call list of portbench/metrics/snake_roofline.py."""
    import importlib.util
    import json
    from pathlib import Path

    import chip_smoke

    model = DAC(seed=0, device="cpu", **DAC_SMALL)
    seen = []
    hooks = [m.register_forward_hook(
        lambda mod, args, out: seen.append(tuple(args[0].shape)))
        for m in model.module.modules() if isinstance(m, Snake1d)]
    x = (0.1 * np.random.default_rng(L).standard_normal((B, L))).astype(
        np.float32)
    model.decode_codes(model.encode_codes(x))
    for h in hooks:
        h.remove()
    assert seen == chip_smoke.dac_snake_calls(DAC_SMALL, B, L)
    assert sum(chip_smoke.dac_snakes(DAC_SMALL)) == len(seen) == 58
    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location(
        "snake_roofline", root / "portbench" / "metrics" / "snake_roofline.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    cfg = json.loads((root / "portbench" / "configs"
                      / "dac-16khz-9kbps.json").read_text())["DAC"]
    cell = chip_smoke.dac_snake_calls(cfg, chip_smoke.DAC_CELL_BATCH,
                                      chip_smoke.DAC_CLIP)
    assert cell == [(16, C, T) for C, T in mod.snake_calls(cfg, 48000)]
    assert sorted({(C, T) for _, C, T in cell}) == sorted(CELL)
