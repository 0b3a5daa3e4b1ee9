"""The port's LayerNorm route and launch plan, on the CPU.

``esc_tpu_torch.modules.scale.LayerNorm`` is ``nn.LayerNorm`` whose
inference runs the LayerNorm kernel (``esc_tpu_torch/csrc/layer_norm.cu``);
a CPU tensor takes the wrapper's plain version, training and ``plain_ops``
take ``F.layer_norm``. The kernel itself is held to ``F.layer_norm`` on a
card by ``tests/test_torch_port_cuda.py``. Here: the plain route bit for
bit, the routing and its gradients, the state dict and type checks of a
whole codec, every width of the repository's configs within the kernel's
maximum, the launch plans, and the call list that
``portbench/metrics/layer_norm_roofline.py`` counts against the LayerNorm
calls a real roundtrip makes.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn as nn

from esc_tpu_torch.models import make_model
from esc_tpu_torch.modules import scale
from esc_tpu_torch.modules.scale import LN_EPS, LayerNorm
from esc_tpu_torch.ops.kernels import KERNELS, layer_norm, layer_norm_plain
from esc_tpu_torch.utils.config import read_yaml
from tests.test_torch_port_conv import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
# the module, not the wrapper the package exports under the same name
ln_mod = importlib.import_module("esc_tpu_torch.ops.kernels.layer_norm")

NUM_SMS = 132           # an H100 SXM
MAX_SMEM = 232448       # 227 KB, a block's shared memory
# every LayerNorm width of ESC-Base and ESC-Large: h_dims and the patch
# merges' 2 h
MAIN_WIDTHS = [45, 72, 90, 96, 144, 192, 288, 384]
SMALL = dict(in_dim=2, in_freq=192, h_dims=[16, 16, 24, 24, 32, 64],
             max_streams=6, win_len=20, hop_len=5, sr=16000,
             patch_size=[3, 2], swin_heads=[2, 2, 4, 4, 4],
             swin_depth=2, window_size=4, mlp_ratio=2.0, overlap=2,
             group_size=3, codebook_size=128, codebook_dims=[8] * 6,
             l2norm=True)


def _roofline_module():
    path = ROOT / "portbench" / "metrics" / "layer_norm_roofline.py"
    spec = importlib.util.spec_from_file_location("layer_norm_roofline", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _affine(rng, C):
    w = torch.tensor(rng.uniform(0.5, 1.5, C), dtype=torch.float32)
    b = torch.tensor(rng.standard_normal(C), dtype=torch.float32)
    return w, b


@pytest.mark.parametrize("C", MAIN_WIDTHS)
def test_plain_route_is_nn_layer_norm_bit_for_bit(C):
    rng = np.random.default_rng(C)
    x = torch.tensor(rng.standard_normal((3, 7, C)) * 4 + 1,
                     dtype=torch.float32)
    ref = nn.LayerNorm(C, eps=LN_EPS)
    w, b = _affine(rng, C)
    with torch.no_grad():
        ref.weight.copy_(w)
        ref.bias.copy_(b)
        want = ref(x)
        assert torch.equal(layer_norm(x, ref.weight, ref.bias, LN_EPS), want)
        assert torch.equal(layer_norm_plain(x, ref.weight, ref.bias, LN_EPS),
                           want)
        ours = LayerNorm(C, eps=LN_EPS).eval()
        ours.load_state_dict(ref.state_dict())
        assert torch.equal(ours(x), want)
        # a strided input (PatchEmbed's transposed tokens)
        xt = x.transpose(0, 1)
        assert not xt.is_contiguous()
        assert torch.equal(ours(xt), ref(xt))


@pytest.mark.parametrize("mode", ["eval", "train", "plain_ops"])
def test_routing(monkeypatch, mode):
    """Inference goes through the kernel's wrapper; training and plain_ops
    through F.layer_norm, with nn.LayerNorm's gradients."""
    calls = []

    def counting(x, weight, bias, eps):
        calls.append(tuple(x.shape))
        return layer_norm_plain(x, weight, bias, eps)

    monkeypatch.setattr(scale, "layer_norm", counting)
    rng = np.random.default_rng(5)
    C = 45
    ours, ref = LayerNorm(C, eps=LN_EPS), nn.LayerNorm(C, eps=LN_EPS)
    w, b = _affine(rng, C)
    with torch.no_grad():
        for m in (ours, ref):
            m.weight.copy_(w)
            m.bias.copy_(b)
    ours.train(mode == "train")
    ref.train(mode == "train")
    ours.plain_ops = mode == "plain_ops"
    x = torch.tensor(rng.standard_normal((4, 5, C)), dtype=torch.float32)
    if mode == "eval":
        with torch.no_grad():
            assert torch.equal(ours(x), ref(x))
        assert calls == [(4, 5, C)]
        return
    xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
    g = torch.tensor(rng.standard_normal((4, 5, C)), dtype=torch.float32)
    ya, yb = ours(xa), ref(xb)
    assert calls == []
    assert torch.equal(ya, yb)
    (ya * g).sum().backward()
    (yb * g).sum().backward()
    assert torch.equal(xa.grad, xb.grad)
    assert torch.equal(ours.weight.grad, ref.weight.grad)
    assert torch.equal(ours.bias.grad, ref.bias.grad)


def _norms(module):
    return [(n, m) for n, m in module.named_modules()
            if isinstance(m, nn.LayerNorm)]


def test_state_dict_and_types_of_a_codec_are_nn_layer_norms():
    model = make_model(SMALL, device="cpu", plain_ops=True)
    norms = _norms(model.module)
    # patch embedding, 2 a Swin block (2 blocks in each of 12 layers), 10
    # patch merges and splits
    assert len(norms) == 1 + 2 * 2 * 12 + 10
    assert all(type(m) is LayerNorm and m.plain_ops for _, m in norms)
    keys = set(model.state_dict())
    for name, m in norms:
        assert set(m.state_dict()) == {"weight", "bias"}
        assert {f"{name}.weight", f"{name}.bias"} <= keys
        assert m.eps == LN_EPS
        assert torch.equal(m.weight, torch.ones_like(m.weight))
        assert torch.equal(m.bias, torch.zeros_like(m.bias))
    # the same keys and shapes as the module built with nn.LayerNorm
    plain = make_model(SMALL, device="cpu")
    for _, m in plain.module.named_modules():
        for child_name, child in list(m.named_children()):
            if type(child) is LayerNorm:
                setattr(m, child_name, nn.LayerNorm(
                    child.normalized_shape, eps=child.eps))
    assert not any(type(m) is LayerNorm for m in plain.module.modules())
    want = {k: v.shape for k, v in plain.module.state_dict().items()}
    assert {k: v.shape for k, v in model.state_dict().items()} == want
    assert not make_model(SMALL, device="cpu").module.encoder.patch_embed \
        .norm.plain_ops


def _config_widths():
    out = []
    for path in sorted((ROOT / "configs").rglob("*.yaml")):
        cfg = read_yaml(str(path))
        if cfg["model"].get("backbone") != "transformer":
            continue
        model = make_model(cfg["model"], cfg["model_name"], device="cpu")
        out.append((path.name, sorted({m.normalized_shape[-1]
                                       for _, m in _norms(model.module)})))
    return out


def test_every_config_width_within_the_kernel():
    seen = _config_widths()
    # ESC-Base, its adversarial stage, ESC-Large, the transformer ablations
    assert len(seen) >= 4
    for name, widths in seen:
        assert widths, name
        assert max(widths) <= ln_mod.MAX_WIDTH, (name, widths)
        for C in widths:
            ln_mod.launch_plan(16 * 64 * 300, C, NUM_SMS)
    assert set(MAIN_WIDTHS) == {C for _, w in seen for C in w}


@pytest.mark.parametrize("rows", [1, 31, 4801, 307200])
@pytest.mark.parametrize("C", MAIN_WIDTHS + [1, 3, 64, 1000, 4096])
def test_launch_plan(rows, C):
    p = ln_mod.launch_plan(rows, C, NUM_SMS)
    assert p.lanes in ln_mod.LANE_GROUPS
    at_once = 32 // p.lanes
    assert p.rows_per_tile >= at_once and p.rows_per_tile % at_once == 0
    # the tile's span, shifted by up to 3 floats to line up its 16-byte
    # pieces, fits its buffer; buffers start on 16 bytes
    assert p.pitch % 4 == 0 and p.pitch >= p.rows_per_tile * C + 3
    assert 1 <= p.warps <= ln_mod.MAX_WARPS
    assert p.smem == ln_mod.smem_bytes(C, p.warps, p.pitch) <= MAX_SMEM
    # every row in exactly one tile; every block has a tile for its first
    # warp
    assert p.tiles == -(-rows // p.rows_per_tile)
    assert (p.tiles - 1) * p.rows_per_tile < rows <= p.tiles * p.rows_per_tile
    assert 1 <= p.grid and (p.grid - 1) * p.warps < p.tiles
    assert p.grid <= NUM_SMS * 32
    # a tile is about TILE_FLOATS, or a warp's rows at once, or the call
    assert p.rows_per_tile * C <= max(ln_mod.TILE_FLOATS, at_once * C)
    # the entry point's plan array, in the order the kernel reads it
    assert list(ln_mod._launch_args(rows, C, NUM_SMS)) == [
        rows, C, p.lanes, p.rows_per_tile, p.warps, p.grid, p.pitch, p.smem]


@pytest.mark.parametrize("C,lanes", [(45, 1), (90, 2), (72, 8), (96, 16),
                                     (144, 16), (192, 32), (288, 32),
                                     (384, 32)])
def test_lane_groups_of_the_main_widths(C, lanes):
    """The plan's lanes a row at ESC's widths, and one read's bank
    conflicts: none, but two-way at 96 (rows 96 floats apart start on one
    bank; one lane a row would be 32-way)."""
    assert ln_mod.lane_group(C) == lanes
    assert ln_mod.bank_conflicts(C, lanes) == (2 if C == 96 else 1)


def test_plan_refuses_widths_beyond_the_kernel():
    for C in (0, ln_mod.MAX_WIDTH + 1):
        with pytest.raises(ValueError):
            ln_mod.launch_plan(10, C, NUM_SMS)


def test_wrapper_is_a_kernel_of_the_port():
    assert KERNELS["layer_norm"] == (layer_norm, layer_norm_plain)
    assert isinstance(layer_norm.launches, int)


def _hooked_calls(model, x, ns):
    """(rows, C) of every LayerNorm call of one roundtrip, by forward
    hooks, in call order."""
    seen = []
    hooks = [m.register_forward_hook(
        lambda mod, args, out: seen.append(
            (args[0].numel() // mod.normalized_shape[-1],
             mod.normalized_shape[-1])))
        for _, m in _norms(model.module)]
    try:
        model.roundtrip(x, num_streams=ns)
    finally:
        for h in hooks:
            h.remove()
    return seen


@pytest.mark.parametrize("ns", [1, 3, 6])
def test_roofline_call_list_is_a_roundtrips_small(ns):
    calls = _roofline_module().layer_norm_calls
    model = make_model(SMALL, device="cpu")
    batch, length = 2, 7920
    x = np.random.default_rng(ns).standard_normal((batch, length)) \
        .astype(np.float32) * 0.1
    with torch.no_grad():
        seen = _hooked_calls(model, x, ns)
    want = calls(SMALL, batch, length, ns)
    assert sorted(seen) == sorted(want)


@pytest.mark.parametrize("ns", [1, 3, 6])
def test_roofline_call_list_is_a_roundtrips_at_the_cell(ns):
    """The serve-batch cell's geometry (ESC-Base, 3 s clips) at one clip:
    the rows of every call grow with the batch."""
    mod = _roofline_module()
    cell = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next(w for w in cell["workloads"]
                if w["name"] == "esc-base.serve-batch")
    cfg = json.loads((ROOT / "portbench" / "configs"
                      / f"{cell['config']}.json").read_text())
    traffic = json.loads((ROOT / "portbench" / "traffic"
                          / f"{cell['traffic']}.json").read_text())
    model = make_model(cfg["model"], cfg["model_name"], device="cpu")
    x = np.random.default_rng(ns).standard_normal(
        (1, traffic["length"])).astype(np.float32) * 0.1
    with torch.no_grad():
        seen = _hooked_calls(model, x, ns)
    one = mod.layer_norm_calls(cfg["model"], 1, traffic["length"], ns)
    assert sorted(seen) == sorted(one)
    full = mod.layer_norm_calls(cfg["model"], traffic["batch"],
                                traffic["length"], ns)
    assert full == [(traffic["batch"] * r, C) for r, C in one]
    if ns == traffic["num_streams"]:
        # 79 calls, 589.8 M elements: 4.72 GB at 8 bytes an element
        assert len(full) == 79
        assert sum(r * C for r, C in full) == 589_824_000
        work = mod.calls(cfg, traffic)
        assert sum(b for b, _ in work) == pytest.approx(
            8 * 589_824_000 + 8 * sum(C for _, C in full))
        assert sum(f for _, f in work) == 8 * 589_824_000
