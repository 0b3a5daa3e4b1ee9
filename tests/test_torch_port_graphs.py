"""Stage graphs (``esc_tpu_torch/utils/graphs.py``): a codec's repeated
``encode`` / ``decode`` calls replayed as one captured CUDA graph a stage.

On a card (marked ``cuda``, skipped without one; the file imports no JAX,
so it runs where JAX is absent):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_graphs.py

- replayed codes and waveforms equal the eager ones bit for bit, at every
  (length, streams) pair of the serve-single traffic, at serve-batch's
  16 x 47,920 at 6 streams, in bf16 and for the ablation codecs;
- a returned tensor outlives the next call; a replay after the caches of
  masks and DFT constants were flooded, after ``load_state_dict``, after
  a move of the module there and back and after a submodule's dtype or a
  parameter's memory changed equals the eager call;
- a capture that fails serves the call eagerly and leaves its key eager;
- first call eager, second captures, third replays; the least recently
  used chain goes beyond the bound; a replay runs, by the profiler's
  kernel records, the kernels an eager call launches and calls no
  wrapper; the spans read as eagerly; two threads on one key each get
  their own answer.

On the CPU: no chain is ever built (the CPU, ``plain_ops``, training),
and, with CUDA's graph calls replaced by stand-ins that run each stage
eagerly, the policy (no capture per call where recurring keys outnumber
the chains), the walk and its spans, the constants a chain holds, the
weights' key, the lock and the failure path.
"""

import contextlib
import copy
import gc
import json
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from esc_tpu_torch.models import ESC, codecs, make_model
from esc_tpu_torch.modules import transformer
from esc_tpu_torch.ops import stft as port_stft
from esc_tpu_torch.ops.kernels import (codebook_argmin, layer_norm,
                                       window_attention)
from esc_tpu_torch.train.trainer import reproducible
from esc_tpu_torch.utils import graphs

REPO = Path(__file__).resolve().parent.parent
ESC_BASE = json.loads((REPO / "portbench/configs/esc-base.json")
                      .read_text())["model"]
SERVE_SINGLE = json.loads((REPO / "portbench/traffic/serve-single.json")
                          .read_text())
SMALL = dict(in_dim=2, in_freq=192, h_dims=[16, 16, 24, 24, 32, 64],
             max_streams=6, patch_size=[3, 2], swin_heads=[2, 2, 4, 4, 4],
             swin_depth=2, window_size=4, mlp_ratio=2.0, overlap=2,
             group_size=3, codebook_size=128, codebook_dims=[8] * 6,
             l2norm=True)
RVQ_SMALL = {k: v for k, v in SMALL.items() if k != "codebook_dims"}
ABLATIONS = {
    "rvq+swinT": dict(RVQ_SMALL, codebook_dim=8, num_rvqs=6),
    "csvq+conv": dict(SMALL, backbone="convolution", kernel_size=[5, 2],
                      conv_depth=1),
    "rvq+conv": dict(RVQ_SMALL, backbone="convolution", kernel_size=[5, 2],
                     conv_depth=1, codebook_dim=8, num_rvqs=6),
}
TINY = dict(SMALL, h_dims=[12, 12, 16, 16, 24, 32], swin_heads=[2] * 5,
            codebook_size=64)
KERNEL_WRAPPERS = (codebook_argmin, window_attention, layer_norm)
NAMES = ("codebook_argmin", "window_attention", "layer_norm")


def _audio(shape, seed):
    return (0.1 * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _launches():
    return [w.launches for w in KERNEL_WRAPPERS]


# -- on the card ------------------------------------------------------------

cuda = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def esc_base_pair(card):
    """(a codec that replays, a codec with the same weights whose every
    call here is a key's first, so eager)."""
    return tuple(make_model(dict(ESC_BASE), "csvq+swinT", seed=5,
                            device=card) for _ in range(2))


def _same_as_eager(g, e, x_warm, x, num_streams):
    """Warm ``g`` on ``x_warm`` (eager, then the capture), replay it on
    ``x`` and hold codes and waveform to ``e``'s eager calls on ``x``."""
    codes_w, fs = g.encode(x_warm, num_streams)
    again, _ = g.encode(x_warm, num_streams)
    assert torch.equal(codes_w, again)          # the capture's eager run
    g.decode(codes_w, fs)
    g.decode(codes_w, fs)
    sg = g._graphs()
    assert len(sg.chains) >= 2
    codes_g, fs_g = g.encode(x, num_streams)
    codes_e, fs_e = e.encode(x, num_streams)
    assert fs_g == fs_e and torch.equal(codes_g, codes_e)
    wave_g = g.decode(codes_e, fs)
    wave_e = e.decode(codes_e, fs)
    assert torch.equal(wave_g, wave_e)
    return codes_g, wave_g


@cuda
@pytest.mark.parametrize("length", SERVE_SINGLE["lengths"])
def test_replay_equals_eager_at_every_serve_single_pair(esc_base_pair,
                                                        length):
    g, e = esc_base_pair
    for s in SERVE_SINGLE["streams"]:
        _same_as_eager(g, e, _audio((1, length), s),
                       _audio((1, length), 100 + s), s)


@cuda
def test_replay_equals_eager_at_the_serve_batch_shape(esc_base_pair):
    g, e = esc_base_pair
    _same_as_eager(g, e, _audio((16, 47920), 1), _audio((16, 47920), 2), 6)


@cuda
def test_bf16_replay_equals_eager(card):
    g, e = (ESC(seed=2, device=card, dtype=torch.bfloat16, **SMALL)
            for _ in range(2))
    _same_as_eager(g, e, _audio((2, 15920), 1), _audio((2, 15920), 2), 6)


@cuda
@pytest.mark.parametrize("name", list(ABLATIONS))
def test_ablation_replay_equals_eager(card, name):
    """On cuDNN's deterministic algorithms: its default transposed
    convolutions add partial sums by atomics, in any order, so that two
    eager decodes of the convolution backbone differ in the last bits."""
    g, e = (make_model(ABLATIONS[name], name, seed=2, device=card)
            for _ in range(2))
    reproducible(_same_as_eager)(g, e, _audio((2, 15920), 1),
                                 _audio((2, 15920), 2), 3)


@cuda
def test_a_result_outlives_the_next_call(card):
    g = ESC(seed=2, device=card, **SMALL)
    x1, x2 = _audio((2, 15920), 1), _audio((2, 15920), 2)
    for _ in range(2):
        codes, fs = g.encode(x1, 6)
        wave = g.decode(codes, fs)
    codes1, _ = g.encode(x1, 6)
    wave1 = g.decode(codes1, fs)
    kept = codes1.clone(), wave1.clone()
    codes2, _ = g.encode(x2, 6)
    wave2 = g.decode(codes2, fs)
    torch.cuda.synchronize()
    assert not torch.equal(codes1, codes2) and not torch.equal(wave1, wave2)
    assert torch.equal(codes1, kept[0]) and torch.equal(wave1, kept[1])


@cuda
def test_replay_reads_its_constants_after_the_caches_were_flooded(card):
    g, e = (ESC(seed=2, device=card, **SMALL) for _ in range(2))
    x1, x2 = _audio((2, 15920), 1), _audio((2, 15920), 2)
    for _ in range(2):
        codes, fs = g.encode(x1, 6)
        g.decode(codes, fs)
    _flood(card)
    gc.collect()
    junk = [torch.full((n,), float("nan"), device=card)
            for n in range(256, 40000, 97)]
    codes_g, _ = g.encode(x2, 6)
    codes_e, _ = e.encode(x2, 6)
    assert torch.equal(codes_g, codes_e)
    assert torch.equal(g.decode(codes_e, fs), e.decode(codes_e, fs))
    del junk


def _flood(card):
    """Eager calls of 80 other shapes of both constant caches: they evict
    what they held."""
    masks = transformer._mask_cached.cache_info().misses
    consts = port_stft._on_device_cached.cache_info().misses
    for k in range(80):
        transformer._mask_on(8 + k, 40, 4, 2, card)
        port_stft._on_device(port_stft._ola_envelope, (382, 320, 80, 50 + k),
                             -1, card)
    assert transformer._mask_cached.cache_info().misses >= masks + 80
    assert port_stft._on_device_cached.cache_info().misses >= consts + 80


@cuda
def test_a_capture_after_the_caches_were_flooded_succeeds(card, recwarn):
    """A key's constants evicted between its first and second call: the
    second call's eager run uploads them again before the capture, which
    would fail on an upload from pageable memory."""
    g, e = (ESC(seed=2, device=card, **SMALL) for _ in range(2))
    x1, x2 = _audio((2, 15920), 1), _audio((2, 15920), 2)
    codes, fs = g.encode(x1, 6)
    g.decode(codes, fs)
    _flood(card)
    codes, fs = g.encode(x1, 6)
    g.decode(codes, fs)
    assert len(g._graphs().chains) == 2
    assert not [w for w in recwarn if "not captured" in str(w.message)]
    codes_g, _ = g.encode(x2, 6)
    codes_e, _ = e.encode(x2, 6)
    assert torch.equal(codes_g, codes_e)
    assert torch.equal(g.decode(codes_e, fs), e.decode(codes_e, fs))


@cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_load_state_dict_after_capture_reaches_the_replay(card, dtype):
    g = ESC(seed=2, device=card, dtype=dtype, **SMALL)
    e = ESC(seed=7, device=card, dtype=dtype, **SMALL)
    x1, x2 = _audio((2, 15920), 1), _audio((2, 15920), 2)
    for _ in range(2):
        codes, fs = g.encode(x1, 6)
        g.decode(codes, fs)
    before, _ = g.encode(x2, 6)
    chains = dict(g._graphs().chains)
    g.load_state_dict(e.state_dict())
    codes_g, _ = g.encode(x2, 6)
    assert dict(g._graphs().chains) == chains       # replayed, not captured
    codes_e, _ = e.encode(x2, 6)
    assert not torch.equal(before, codes_g)
    assert torch.equal(codes_g, codes_e)
    assert torch.equal(g.decode(codes_e, fs), e.decode(codes_e, fs))


@cuda
def test_a_module_moved_there_and_back_drops_its_chains(card):
    g, e = (ESC(seed=2, device=card, **SMALL) for _ in range(2))
    x1, x2 = _audio((2, 15920), 1), _audio((2, 15920), 2)
    for _ in range(2):
        g.encode(x1, 6)
    assert len(g._graphs().chains) == 1
    g.module.to("cpu")
    taken = [torch.empty(p.numel(), device=card)     # the memory it had
             for p in g.module.parameters()]
    g.module.to(card)
    codes_g, _ = g.encode(x2, 6)
    assert len(g._graphs().chains) == 0
    assert torch.equal(codes_g, e.encode(x2, 6)[0])
    del taken


def _change(module, how):
    """Change ``module``'s weights as a user might after a capture."""
    sub = module.encoder.blocks[1]
    with torch.no_grad():
        if how == "half":                   # in memory of its own
            sub.half()
            for p in sub.parameters():
                p.mul_(1.5)
            sub.float()
        for p in sub.parameters():
            if how == "data":
                p.data = p.data * 1.5
            elif how == "set_":
                p.set_(p.detach() * 1.5)


@cuda
@pytest.mark.parametrize("how", ["half", "data", "set_"])
def test_a_changed_submodule_after_capture_reaches_the_replay(card, how):
    g, e = (ESC(seed=2, device=card, **SMALL) for _ in range(2))
    x1, x2 = _audio((2, 15920), 1), _audio((2, 15920), 2)
    for _ in range(2):
        codes, fs = g.encode(x1, 6)
        g.decode(codes, fs)
    sg = g._graphs()
    weights = sg.weights
    before, _ = g.encode(x2, 6)
    for model in (g, e):
        _change(model.module, how)
    codes_g, _ = g.encode(x2, 6)
    codes_e, _ = e.encode(x2, 6)
    assert not torch.equal(before, codes_g)
    assert torch.equal(codes_g, codes_e)
    assert torch.equal(g.decode(codes_e, fs), e.decode(codes_e, fs))
    if how != "half":       # new memory while the old lived: a new address
        assert sg.weights != weights


@cuda
def test_two_threads_on_one_key_each_get_their_own_answer(card):
    g, e = (ESC(seed=2, device=card, **SMALL) for _ in range(2))
    xs = [_audio((1, 15920), k) for k in range(2)]
    want = [e.encode(x, 6)[0] for x in xs]
    for _ in range(2):
        g.encode(xs[0], 6)
    wrong = []

    def serve(k):
        for _ in range(50):
            codes, _ = g.encode(xs[k], 6)
            if not torch.equal(codes, want[k]):
                wrong.append(k)
    threads = [threading.Thread(target=serve, args=(k,)) for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not wrong
    assert g._graphs().chains[("encode", (1, 15920), 6,
                               torch.float32)].replays == 100


@cuda
def test_a_replay_runs_the_kernels_an_eager_call_launches(card):
    """By the profiler's kernel records, which CUPTI takes of a graph's
    kernels too; the wrappers count the eager call's launches alone."""
    g, e = (ESC(seed=2, device=card, **SMALL) for _ in range(2))
    x = _audio((2, 15920), 1)
    n = _launches()
    e.encode(x, 6)
    torch.cuda.synchronize()
    eager = dict(zip(NAMES, (b - a for a, b in zip(n, _launches()))))
    for _ in range(2):
        g.encode(x, 6)
    chain = g._graphs().chains[("encode", (2, 15920), 6, torch.float32)]
    assert chain.kernels == eager and chain.replays == 0
    n = _launches()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        g.encode(x, 6)
        torch.cuda.synchronize()
    assert _launches() == n and chain.replays == 1
    ran = {name: sum(ev.count for ev in prof.key_averages()
                     if sub in ev.key and "at::" not in ev.key
                     and "CUDA" in str(ev.device_type))
           for name, sub in zip(NAMES, ("codebook_argmin", "window_attention",
                                        "layer_norm_kernel"))}
    assert ran == eager and min(eager.values()) > 0


@cuda
def test_a_failed_capture_serves_the_call_eagerly(card, monkeypatch):
    g = ESC(seed=2, device=card, **SMALL)
    real = codecs.spec_transform

    def syncing(x, *args):
        if float(x.abs().sum()) < 0:        # a host sync: not capturable
            raise AssertionError
        return real(x, *args)
    monkeypatch.setattr(codecs, "spec_transform", syncing)
    x = _audio((2, 15920), 1)
    first, _ = g.encode(x, 6)
    with pytest.warns(RuntimeWarning, match="not captured"):
        second, _ = g.encode(x, 6)
    third, _ = g.encode(x, 6)
    sg = g._graphs()
    key = ("encode", (2, 15920), 6, torch.float32)
    assert not sg.chains and sg.seen[key] is False
    assert torch.equal(first, second) and torch.equal(first, third)
    codes, fs = g.encode(_audio((2, 15920), 2), 6)      # the card is sound
    torch.cuda.synchronize()
    assert codes.shape == first.shape


@cuda
def test_eager_then_capture_then_replay_and_the_bound(card, monkeypatch):
    g = ESC(seed=2, device=card, **SMALL)
    sg = g._graphs()
    x = _audio((1, 15920), 1)
    key = ("encode", (1, 15920), 6, torch.float32)
    counts = []
    for _ in range(3):
        n = _launches()
        g.encode(x, 6)
        torch.cuda.synchronize()
        counts.append([b - a for a, b in zip(n, _launches())])
        if len(counts) == 1:
            assert sg.seen[key] is True and key not in sg.chains
    # the wrappers count the eager calls and the capture, not the replay
    assert counts[1] == [2 * n for n in counts[0]] and counts[0][2] > 0
    assert counts[2] == [0, 0, 0]
    chain = sg.chains[key]
    assert chain.replays == 1
    assert chain.kernels == {k: n for k, n in zip(NAMES, counts[0]) if n}
    g.encode(x, 6)
    assert sg.chains[key] is chain and chain.replays == 2
    monkeypatch.setattr(graphs, "MAX_CHAINS", 2)
    monkeypatch.setattr(graphs, "SEEN", 4)
    other = _audio((1, 31920), 2)
    for _ in range(2):
        g.encode(other, 6)
    for _ in range(4):                      # the first chain idles
        g.encode(other, 6)
    last = _audio((1, 47920), 2)
    for _ in range(3):                      # eager, capture, replay
        codes_g, _ = g.encode(last, 6)
    assert key not in sg.chains and len(sg.chains) == 2
    e = ESC(seed=2, device=card, **SMALL)   # in memory the dropped chain had
    assert torch.equal(codes_g, e.encode(last, 6)[0])
    g.encode(x, 6)                          # a first call again: eager
    assert key not in sg.chains and sg.seen[key] is True


@cuda
def test_replayed_spans_hold_the_eager_stages(card):
    g = ESC(seed=2, device=card, **SMALL)
    x = _audio((1, 15920), 1)

    def spans():
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            codes, fs = g.encode(x, 3)
            g.decode(codes, fs)
        return prof.events()
    eager, capture, replay = spans(), spans(), spans()
    _hold_the_eager_stages(eager, capture, replay)


def _hold_the_eager_stages(eager, capture, replay):
    """A roundtrip's spans: each call's upload, then its stages, eagerly;
    a capture's call adds its capture, which holds the stages in their
    order; a replay's, the replay, which holds them in their order."""
    stages = {p: [n for n in _children(eager, p) if n != "codec.upload"]
              for p in ("codec.encode", "codec.decode")}
    enc, dec = stages["codec.encode"], stages["codec.decode"]
    assert enc[0] == "codec.stft" and dec[-1] == "codec.istft"
    for parent in ("codec.encode", "codec.decode"):
        assert _children(eager, parent)[0] == "codec.upload"
        assert _children(capture, parent) == (
            ["codec.upload"] + stages[parent] + ["codec.capture"])
        assert _children(replay, parent) == ["codec.upload", "codec.replay"]
    assert _children(replay, "codec.replay") == enc + dec
    assert _children(capture, "codec.capture") == enc + dec


def _children(events, parent):
    """The span names directly under the spans ``parent``, in order."""
    return [e.name for e in sorted(events, key=lambda e: e.time_range.start)
            if e.cpu_parent is not None and e.cpu_parent.name == parent
            and not e.name.startswith(("aten::", "cuda"))]


# -- on the CPU -------------------------------------------------------------

@pytest.fixture
def tiny():
    return ESC(seed=3, device="cpu", **TINY)


def test_no_chain_on_the_cpu_with_plain_ops_or_in_training(tiny):
    x = _audio((1, 7920), 1)
    plain = ESC(seed=3, device="cpu", plain_ops=True, **TINY)
    for model in (tiny, plain):
        for _ in range(3):
            codes, fs = model.encode(x, 3)
            model.decode(codes, fs)
        assert model._graphs() is None
        assert "_stage_graphs" not in model.__dict__
    tiny.device = torch.device("cuda")      # the gate alone, no card used
    plain.device = torch.device("cuda")
    assert plain._graphs() is None
    tiny.module.train()
    assert tiny._graphs() is None
    tiny.module.eval()
    assert isinstance(tiny._graphs(), graphs.StageGraphs)


class _Graph:
    """A stand-in for ``torch.cuda.CUDAGraph`` on the CPU: nothing is
    captured, so a stage's operators run while it is "captured", and a
    replay launches nothing (its outputs stay the capture's)."""

    log: list = []

    def capture_begin(self, pool=None, capture_error_mode="global"):
        assert capture_error_mode == "thread_local"
        self.log.append("capture")

    def capture_end(self):
        pass

    def replay(self):
        self.log.append("replay")


class _Stream:
    def wait_stream(self, other):
        pass

    def wait_event(self, event):
        assert isinstance(event, _Event)


class _Event:
    def record(self):
        pass


@pytest.fixture
def stand_ins(monkeypatch):
    """CUDA's graph calls replaced for a run on the CPU."""
    _Graph.log = []
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _Stream())
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda stream: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: _Stream())
    return _Graph.log


@pytest.fixture
def replaying(tiny, stand_ins, monkeypatch):
    """The tiny codec with stage graphs on the CPU (the stand-ins')."""
    sg = graphs.StageGraphs(tiny.module, tiny.device)
    monkeypatch.setattr(tiny, "_graphs", lambda: sg)
    return tiny, sg, stand_ins


def test_policy_eager_capture_replay(replaying):
    model, sg, log = replaying
    x = _audio((1, 7920), 1)
    key = ("encode", (1, 7920), 3, torch.float32)
    first, _ = model.encode(x, 3)
    assert log == [] and sg.seen[key] is True and not sg.chains
    second, _ = model.encode(x, 3)
    stages = len(sg.chains[key].names)
    assert log == ["capture"] * stages           # after its eager run
    assert torch.equal(first, second) and key not in sg.seen
    third, _ = model.encode(_audio((1, 7920), 2), 3)
    assert log[stages:] == ["replay"] * stages
    # the stand-in replays launch nothing: the capture's outputs come back
    assert torch.equal(third, second) and third is not second


def test_least_recently_used_chain_goes(replaying, monkeypatch):
    model, sg, _ = replaying
    monkeypatch.setattr(graphs, "MAX_CHAINS", 2)
    monkeypatch.setattr(graphs, "SEEN", 4)
    keys = [("encode", (1, n), 2, torch.float32) for n in (3120, 7920, 12720)]
    for key in keys[:2]:
        for _ in range(2):
            model.encode(_audio(key[1], 1), 2)
    for _ in range(4):              # the first is used last, the second idles
        model.encode(_audio(keys[0][1], 1), 2)
    for _ in range(2):
        model.encode(_audio(keys[2][1], 1), 2)
    assert list(sg.chains) == [keys[0], keys[2]]
    assert len(sg.seen) == 0


def test_recurring_keys_beyond_the_bound_keep_the_chains(replaying,
                                                        monkeypatch):
    """Three keys in turn over two chains: the third key's second call
    finds the least recently used chain used two calls ago and runs
    eagerly, so that no call captures after the first two captures."""
    model, sg, log = replaying
    monkeypatch.setattr(graphs, "MAX_CHAINS", 2)
    monkeypatch.setattr(graphs, "SEEN", 4)
    lengths = (3120, 7920, 12720)
    for _ in range(10):
        for n in lengths:
            model.encode(_audio((1, n), 1), 2)
    chains = list(sg.chains.values())
    assert [key[1][1] for key in sg.chains] == [3120, 7920]
    assert log.count("capture") == sum(len(c.names) for c in chains)
    assert [c.replays for c in chains] == [8, 8]
    assert sg.seen[("encode", (1, 12720), 2, torch.float32)] is True


def test_a_place_is_freed_again_once_the_last_taker_paid(replaying,
                                                          monkeypatch):
    """Two chains full: a third key takes an idle chain's place; a fourth
    key's second call runs eagerly while the third's chain has not been
    replayed and is younger than SEEN calls, and captures once it was."""
    model, sg, _ = replaying
    monkeypatch.setattr(graphs, "MAX_CHAINS", 2)
    monkeypatch.setattr(graphs, "SEEN", 4)
    xs = {n: _audio((1, n), 1) for n in (3120, 7920, 12720, 17520)}
    key = {n: ("encode", (1, n), 2, torch.float32) for n in xs}
    for n in (3120, 7920):
        for _ in range(2):
            model.encode(xs[n], 2)
    for n in (22320, 27120, 31920, 36720):      # both chains idle
        model.encode(_audio((1, n), 1), 2)
    model.encode(xs[12720], 2)
    model.encode(xs[12720], 2)                  # takes 3120's place
    assert list(sg.chains) == [key[7920], key[12720]]
    model.encode(xs[17520], 2)
    model.encode(xs[17520], 2)                  # its second call: eager
    assert list(sg.chains) == [key[7920], key[12720]]
    assert sg.seen[key[17520]] is True
    model.encode(xs[12720], 2)                  # the taker is replayed
    model.encode(xs[17520], 2)                  # takes 7920's place
    assert list(sg.chains) == [key[12720], key[17520]]


def test_chains_go_with_a_moved_or_registered_tensor(replaying):
    model, sg, _ = replaying
    x = _audio((1, 7920), 1)
    for _ in range(2):
        model.encode(x, 3)
    assert len(sg.chains) == 1
    old = list(model.module.parameters())   # its memory stays taken
    model.module.to(torch.float64)
    model.module.to(torch.float32)
    model.encode(x, 3)
    assert not sg.chains
    for _ in range(2):
        model.encode(x, 3)
    assert len(sg.chains) == 1
    owner, name = _a_buffer(model.module)
    owner.register_buffer(name, owner._buffers[name].clone())
    model.encode(x, 3)
    assert not sg.chains
    del old


def _a_buffer(module):
    """(the first submodule that holds a buffer, the buffer's name)."""
    return next((m, n) for m in module.modules()
                for n, b in m._buffers.items() if b is not None)


@pytest.mark.parametrize("how", ["half", "to", "data", "set_", "buffer",
                                 "parameter", "submodule"])
def test_the_weights_key_follows_every_tensor(tiny, how):
    """Each of these gives a tensor the graphs read memory of its own, or
    puts another tensor or submodule in its place: the key changes.
    (The old memory is kept meanwhile, so that no address comes back.)"""
    sg = graphs.StageGraphs(tiny.module, tiny.device)
    keep = [t.detach() for t in tiny.module.state_dict().values()]
    blk = tiny.module.encoder.blocks[1]
    p = next(blk.parameters())
    with torch.no_grad():
        if how == "half":
            blk.half()
        elif how == "to":
            tiny.module.decoder.to(torch.float64)
        elif how == "data":
            p.data = p.data.clone()
        elif how == "set_":
            p.set_(p.detach().clone())
        elif how == "buffer":
            owner, name = _a_buffer(blk)
            owner._buffers[name] = owner._buffers[name].clone()
        elif how == "parameter":
            owner = next(m for m in blk.modules() if m._parameters)
            name = next(iter(owner._parameters))
            setattr(owner, name,
                    torch.nn.Parameter(owner._parameters[name].clone()))
        else:
            owner = next(m for m in blk.modules() if m._modules)
            name = next(iter(owner._modules))
            setattr(owner, name, copy.deepcopy(owner._modules[name]))
    assert sg._weights_key() != sg.weights
    del keep


def test_the_weights_key_holds_for_weights_loaded_in_place(tiny):
    sg = graphs.StageGraphs(tiny.module, tiny.device)
    other = ESC(seed=9, device="cpu", **TINY)
    tiny.load_state_dict(other.state_dict())
    assert sg._weights_key() == sg.weights


def test_calls_take_turns_at_the_chains(replaying, monkeypatch):
    """Two threads replaying one key: each replay (upload, walk, result)
    ends before the other thread's upload."""
    model, sg, _ = replaying
    x = _audio((1, 7920), 1)
    for _ in range(2):
        model.encode(x, 3)
    inside, overlaps = [0], []
    replay = graphs._Chain.replay

    def slow(chain, fn):
        inside[0] += 1
        overlaps.append(inside[0])
        time.sleep(0.002)
        try:
            return replay(chain, fn)
        finally:
            inside[0] -= 1
    monkeypatch.setattr(graphs._Chain, "replay", slow)
    threads = [threading.Thread(target=lambda: [model.encode(x, 3)
                                                for _ in range(5)])
               for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(overlaps) == 10 and max(overlaps) == 1


def test_a_walk_that_leaves_its_graphs_raises(replaying):
    model, sg, _ = replaying
    x = _audio((1, 7920), 1)
    for _ in range(2):
        model.encode(x, 3)
    chain = sg.chains[("encode", (1, 7920), 3, torch.float32)]
    chain.names[2] = "encoder.s9"
    with pytest.raises(RuntimeError, match="left its graphs"):
        model.encode(x, 3)


def test_a_failed_capture_marks_the_key_eager(replaying, monkeypatch):
    model, sg, log = replaying
    real = codecs.spec_transform

    def uncapturable(x, *args):
        if graphs.capturing():
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
        return real(x, *args)
    monkeypatch.setattr(codecs, "spec_transform", uncapturable)
    x = _audio((1, 7920), 1)
    first, _ = model.encode(x, 3)
    with pytest.warns(RuntimeWarning, match="not captured"):
        second, _ = model.encode(x, 3)
    third, _ = model.encode(x, 3)
    key = ("encode", (1, 7920), 3, torch.float32)
    assert sg.seen[key] is False and not sg.chains
    assert torch.equal(first, second) and torch.equal(first, third)
    assert log == ["capture"]                   # the stft stage's, abandoned


def test_a_chain_holds_the_cached_constants_it_read(replaying):
    model, sg, _ = replaying
    x = _audio((1, 7920), 1)
    for _ in range(2):
        codes, fs = model.encode(x, 6)
        model.decode(codes, fs)
    enc = sg.chains[("encode", (1, 7920), 6, torch.float32)]
    dec = sg.chains[("decode", tuple(codes.shape), codes.dtype, fs,
                     torch.float32)]
    dft = port_stft._on_device(port_stft._dft_matrices, (382, 320), 0,
                               torch.device("cpu"))
    idft = port_stft._on_device(port_stft._dft_matrices, (382, 320), 1,
                                torch.device("cpu"))
    assert any(t is dft for t in enc.held)
    assert any(t is idft for t in dec.held)
    masks = {id(t) for t in enc.held if t.dim() == 3}
    assert masks, "the shifted windows' masks"
    assert not graphs.capturing()


def test_bf16_casts_are_made_inside_a_capture(stand_ins):
    layer = torch.nn.Linear(4, 4)
    x = torch.randn(2, 4)
    with torch.no_grad():
        transformer._linear(layer, x, torch.bfloat16)
        cached = layer._cast
        chain = graphs._Chain(torch.zeros(1), None)
        chain.capturing = True
        graphs._ACTIVE.chain = chain
        try:
            out = transformer._linear(layer, x, torch.bfloat16)
        finally:
            graphs._ACTIVE.chain = None
    assert layer._cast is cached and out.dtype == torch.bfloat16


def test_replayed_spans_on_the_cpu(replaying):
    model, _, _ = replaying
    x = _audio((1, 7920), 1)

    def spans():
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            codes, fs = model.encode(x, 3)
            model.decode(codes, fs)
        return prof.events()
    eager, capture, replay = spans(), spans(), spans()
    _hold_the_eager_stages(eager, capture, replay)
