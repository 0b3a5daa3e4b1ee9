"""The port's own spans and the benchmark's readers of them.

- Under ``torch.profiler`` (CPU activity), a roundtrip of the tiny ESC
  records the spans of ``esc_tpu_torch/utils/profiling.py``'s families,
  nested as it states, one ``vq.s{i}`` per transmitted scale, and every
  ``aten::`` operator inside ``codec.encode`` / ``codec.decode`` lies under
  a stage span, so that the stages add up to the calls.
- ``stream_map`` records one ``serving.*`` span of each kind per batch; a
  training step each ``train.*``, ``gen.*`` (and the adversarial step's
  ``disc.*``) span once.
- With no profiler recording, ``annotate`` hands out one shared no-op
  context and never reaches ``torch.profiler.record_function``.
- Each of the benchmark's span readers (``portbench/spans.py``,
  ``portbench/metrics/``) reads a known value from a hand-built Chrome
  trace and nothing where its spans are absent or no device ran.
"""

import argparse
import contextlib
import re
import types
import weakref

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from esc_tpu_torch.io import save_wav
from esc_tpu_torch.models import make_model
from esc_tpu_torch.serving import stream_map, stream_roundtrip
from esc_tpu_torch.train import Trainer
from esc_tpu_torch.train import trainer_adv
from esc_tpu_torch.train.trainer_adv import TrainerAdv
from esc_tpu_torch.utils import profiling
from portbench import run as bench_run
from portbench import spans as bench_spans
from portbench.tests.tiny import TINY_MODEL
from portbench.trace import UNIT, WINDOW, Trace
from tests.test_torch_port_conv import one_torch_thread  # noqa: F401

L = 7920                # 100 STFT frames
STAGES = ("codec.upload", "codec.stft", "codec.istft", "encoder.", "vq.",
          "decoder.")


@pytest.fixture(scope="module")
def esc():
    return make_model(dict(TINY_MODEL), "csvq+swinT", device="cpu")


def _audio(batch=2, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (batch, L)).astype(np.float32)


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return prof.events()


def _chain(event):
    """The names of ``event``'s enclosing events, innermost first."""
    out, p = [], event.cpu_parent
    while p is not None:
        out.append(p.name)
        p = p.cpu_parent
    return out


def _spans(events, parent):
    """The span names directly under the span ``parent``, in order."""
    return [e.name for e in sorted(events, key=lambda e: e.time_range.start)
            if e.cpu_parent is not None and e.cpu_parent.name == parent
            and not e.name.startswith("aten::")]


def _uncovered(events):
    """The ``aten::`` operators inside ``codec.encode`` / ``codec.decode``
    under no stage span."""
    out = []
    for e in events:
        if not e.name.startswith("aten::"):
            continue
        chain = _chain(e)
        if {"codec.encode", "codec.decode"} & set(chain) and not any(
                c.startswith(STAGES) for c in chain):
            out.append((e.name, chain))
    return out


@pytest.mark.parametrize("num_streams", [1, 3, 6])
def test_roundtrip_spans_nest_and_cover_the_calls(esc, num_streams):
    x = _audio()
    esc.roundtrip(x, num_streams)               # warm, off the profiler
    events = _profiled(lambda: esc.roundtrip(x, num_streams))
    top = [e.name for e in events if e.cpu_parent is None
           and not e.name.startswith("aten::")]
    assert top == ["codec.encode", "codec.decode"]
    vq = [f"vq.s{i}" for i in range(num_streams)]
    # encode runs the decoder's layers between its scales, the last scale
    # sent ending it
    scales = vq[:1]
    for i in range(1, num_streams):
        scales.append(vq[i])
        if i < num_streams - 1:
            scales.append(f"decoder.s{i - 1}")
    assert _spans(events, "codec.encode") == (
        ["codec.upload", "codec.stft", "encoder.embed"]
        + [f"encoder.s{i}" for i in range(5)] + scales)
    dec = [vq[0]]
    for i in range(5):
        if i < num_streams - 1:
            dec.append(vq[i + 1])
        dec.append(f"decoder.s{i}")
    assert _spans(events, "codec.decode") == (
        ["codec.upload"] + dec + ["decoder.post", "codec.istft"])
    for e in events:                    # stages hold no span of their own
        if e.name.startswith(STAGES):
            assert not any(c.name.startswith(STAGES) or c.name.startswith(
                "codec.") for c in e.cpu_children), e.name
    assert _uncovered(events) == []


def test_rvq_roundtrip_stages_cover_the_calls():
    model = make_model(dict(TINY_MODEL), "rvq+swinT", device="cpu")
    x = _audio(1)
    model.roundtrip(x, 3)
    events = _profiled(lambda: model.roundtrip(x, 3))
    assert _spans(events, "codec.encode") == (
        ["codec.upload", "codec.stft", "encoder.embed"]
        + [f"encoder.s{i}" for i in range(5)] + ["vq.s0"])
    assert _spans(events, "codec.decode") == (
        ["codec.upload", "vq.s0"] + [f"decoder.s{i}" for i in range(5)]
        + ["decoder.post", "codec.istft"])
    assert _uncovered(events) == []


def test_eval_forward_runs_every_scale_under_its_span(esc):
    events = _profiled(lambda: esc(_audio(1), 6))
    names = [e.name for e in events if not e.name.startswith("aten::")]
    for i in range(6):
        assert names.count(f"vq.s{i}") == 1
    assert names.count("decoder.post") == 1
    assert names.count("codec.stft") == names.count("codec.istft") == 1


@pytest.mark.parametrize("depth", [1, 2])
def test_stream_map_spans_one_of_each_kind_per_batch(depth):
    batches = [_audio(1, seed=k) for k in range(3)]
    events = _profiled(lambda: list(stream_map(
        lambda x: x * 2, batches, depth=depth, device="cpu")))
    names = [e.name for e in events if e.name.startswith("serving.")]
    for kind in ("upload", "launch", "download", "wait"):
        assert names.count(f"serving.{kind}") == len(batches), kind
    assert all(e.cpu_parent is None for e in events
               if e.name.startswith("serving."))


def test_stream_roundtrip_launches_the_codec_inside_serving_launch(esc):
    batches = [_audio(1, seed=k) for k in range(2)]
    events = _profiled(lambda: list(stream_roundtrip(esc, batches,
                                                     num_streams=2)))
    calls = [e for e in events if e.name in ("codec.encode",
                                             "codec.decode")]
    assert len(calls) == 4
    assert {e.cpu_parent.name for e in calls} == {"serving.launch"}


# -- training steps -----------------------------------------------------

DISC = {"sample_rate": 16000, "rates": [], "periods": [2, 3],
        "fft_sizes": [512, 256], "bands": [[0.0, 0.25], [0.25, 1.0]]}
STEP_L = 4720


def _trainer(cls, tmp_path):
    wavs = tmp_path / "wavs"
    wavs.mkdir()
    save_wav(str(wavs / "0.wav"), np.zeros(STEP_L + 80, np.float32))
    cfg = {"data": {"train_data_path": str(wavs), "val_data_path": str(wavs),
                    "num_workers": 0, "train_bs_per_device": 2,
                    "val_bs_per_device": 2},
           "model_name": "csvq+swinT", "model": dict(TINY_MODEL),
           "loss": {"stft_weight": 1.0, "cm_weight": 0.25, "cb_weight": 1.0,
                    "mel_weight": 15.0, "gen_weight": 1.0,
                    "feat_weight": 2.0}}
    if cls is TrainerAdv:
        cfg["discriminator"] = dict(DISC)
    args = argparse.Namespace(
        exp_name="spans", lr=1e-4, num_epochs=1, num_pretraining_epochs=0,
        num_warmup_steps=0, val_metric="SISDR", scheduler_type="constant",
        dropout_rate=0.0, pretrain_ckp=None, log_steps=1, save_path=None,
        seed=3, resume=False, device="cpu")
    t = cls(cfg, args)
    t.model, _, _ = t.load()
    return t


@pytest.mark.parametrize("cls", [Trainer, TrainerAdv])
def test_a_training_step_records_each_phase_once(cls, tmp_path):
    t = _trainer(cls, tmp_path)
    x = _audio(2)[:, :STEP_L]
    events = _profiled(lambda: t.train_step(x, 6, False))
    names = [e.name for e in events if re.match(r"(train|gen|disc)\.",
                                                e.name)]
    want = ["train.step", "train.upload", "gen.forward", "gen.loss",
            "gen.backward", "gen.update"]
    if cls is TrainerAdv:
        want += ["disc.loss", "disc.backward", "disc.update"]
    assert sorted(names) == sorted(want)
    by = {e.name: e for e in events if e.name in want}
    assert by["train.step"].cpu_parent is None
    for name in want[1:]:
        assert "train.step" in _chain(by[name]), name
    phases = sorted(want[2:], key=lambda n: by[n].time_range.start)
    assert phases == want[2:]           # in the step's order of work


@pytest.mark.parametrize("cls", [Trainer, TrainerAdv])
def test_a_step_releases_its_graphs_before_each_update(cls, tmp_path,
                                                       monkeypatch):
    """The forward's output (and the discriminator's loss) die inside the
    backward span, so that the autograd graph's release is timed there."""
    t = _trainer(cls, tmp_path)
    alive, seen = [], []
    forward = t.model.module.forward

    def spy_forward(*args, **kwargs):
        out = forward(*args, **kwargs)
        alive.append(weakref.ref(out["recon_audio"]))
        return out
    monkeypatch.setattr(t.model.module, "forward", spy_forward)
    disc_loss = trainer_adv.discriminator_loss

    def spy_disc_loss(*args):
        loss = disc_loss(*args)
        alive.append(weakref.ref(loss))
        return loss
    monkeypatch.setattr(trainer_adv, "discriminator_loss", spy_disc_loss)
    update = t._update

    def spy_update(opt, family):
        seen.append((family, [ref() is None for ref in alive]))
        update(opt, family)
    monkeypatch.setattr(t, "_update", spy_update)
    t.train_step(_audio(2)[:, :STEP_L], 6, False)
    want = [("gen", [True])]
    if cls is TrainerAdv:
        want.append(("disc", [True, True]))
    assert seen == want


def test_a_freeze_step_has_no_discriminator_phases(tmp_path):
    t = _trainer(TrainerAdv, tmp_path)
    events = _profiled(lambda: t.train_step(_audio(2)[:, :STEP_L], 6, True))
    names = {e.name for e in events}
    assert "gen.update" in names
    assert not {n for n in names if n.startswith("disc.")}


# -- the off path ---------------------------------------------------------

def test_annotate_off_is_one_shared_no_op():
    assert not torch.autograd._profiler_enabled()
    assert profiling.annotate("a") is profiling.annotate("b")
    assert isinstance(profiling.annotate("a"), contextlib.nullcontext)
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.annotate("a") is not profiling.annotate("b")


def test_spans_off_never_reach_record_function(esc, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    codes, _, y = esc.roundtrip(_audio(1), 3)
    assert codes.shape[1] == 3 and torch.isfinite(y).all()
    out = list(stream_map(lambda b: b + 1, [_audio(1)], device="cpu"))
    assert len(out) == 1


# -- the benchmark's readers on hand-built traces -------------------------

def _event(name, cat, ts, dur, corr=None, tid=1):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "pid": 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _span(name, ts, dur):
    return _event(name, "user_annotation", ts, dur)


class _Events:
    """A Chrome trace built by hand; times in microseconds."""

    def __init__(self):
        self.events = [_span(WINDOW, 0, 100_000), _span(UNIT, 0, 100_000)]
        self.corr = 0

    def kernel(self, launch_at, dur, name="k"):
        """A launch at ``launch_at`` on the host; its kernel of ``dur``
        later on the device."""
        self.corr += 1
        self.events += [
            _event("cudaLaunchKernel", "cuda_runtime", launch_at, 2,
                   self.corr),
            _event(name, "kernel", 90_000 - self.corr * 100, dur, self.corr,
                   tid=7)]

    def call(self, name, at):
        self.events.append(_event(name, "cuda_runtime", at, 3))

    def run(self, units=2, device=True):
        events = self.events if device else [
            e for e in self.events if e["cat"] != "kernel"]
        return types.SimpleNamespace(traces=[Trace(events)],
                                     traced_units=units)


def _serve_batch_trace():
    """Two batches: per batch a launch span holding encode (stft 3 us,
    encoder 10, vq 2 + 1 nested in one more vq span) and decode (decoder
    7 + 4, istft 5)."""
    ev = _Events()
    for b in range(2):
        t0 = b * 10_000
        ev.events += [
            _span("serving.launch", t0, 4_000),
            _span("codec.encode", t0 + 100, 1_800),
            _span("codec.stft", t0 + 200, 100),
            _span("encoder.s0", t0 + 400, 300),
            _span("vq.s0", t0 + 800, 400),
            _span("vq.s0", t0 + 900, 100),      # nested: counted once
            _span("codec.decode", t0 + 2_000, 1_900),
            _span("decoder.s0", t0 + 2_100, 200),
            _span("decoder.post", t0 + 2_400, 200),
            _span("codec.istft", t0 + 2_700, 200),
        ]
        ev.kernel(t0 + 250, 3)          # stft
        ev.kernel(t0 + 500, 10)         # encoder
        ev.kernel(t0 + 850, 2)          # vq
        ev.kernel(t0 + 950, 1)          # vq, inside the nested span
        ev.kernel(t0 + 2_200, 7)        # decoder
        ev.kernel(t0 + 2_500, 4)        # decoder.post
        ev.kernel(t0 + 2_800, 5)        # istft
        ev.kernel(t0 + 5_000, 50)       # outside every span
    return ev


def _request_trace():
    """Two requests: the encode's pageable upload (a copy and a stream
    synchronize), a free inside decode, and a synchronize outside both."""
    ev = _Events()
    for r in range(2):
        t0 = r * 10_000
        ev.events += [_span("codec.encode", t0, 2_000),
                      _span("codec.upload", t0 + 10, 100),
                      _span("codec.decode", t0 + 3_000, 2_000)]
        ev.call("cudaMemcpyAsync", t0 + 20)
        ev.call("cudaStreamSynchronize", t0 + 40)
        ev.call("cudaFree", t0 + 3_500)
        ev.call("cudaMemcpy", t0 + 3_600)
        ev.call("cudaDeviceSynchronize", t0 + 6_000)    # outside
        ev.kernel(t0 + 500, 5)
    return ev


def _replay_trace():
    """Two requests of an encode and a decode each; three of the four
    calls replayed their stage graphs (a graph launch under a stage span),
    the first encode ran eagerly."""
    ev = _Events()
    for r in range(2):
        t0 = r * 10_000
        ev.events += [_span("codec.encode", t0, 2_000),
                      _span("codec.upload", t0 + 10, 100),
                      _span("codec.decode", t0 + 3_000, 2_000),
                      _span("codec.upload", t0 + 3_010, 100),
                      _span("codec.replay", t0 + 3_200, 1_500),
                      _span("codec.istft", t0 + 4_000, 100)]
        if r:
            ev.events.append(_span("codec.replay", t0 + 200, 1_500))
        ev.kernel(t0 + 500, 5)
        ev.kernel(t0 + 4_050, 5)
    return ev


def _train_trace():
    """Two steps: backward kernels 100 + 40 us, update 8 + 2, forward 30;
    three synchronising calls per step inside ``train.step``, one outside."""
    ev = _Events()
    for s in range(2):
        t0 = s * 40_000
        ev.events += [
            _span("train.step", t0, 30_000),
            _span("train.upload", t0 + 10, 100),
            _span("gen.forward", t0 + 200, 1_000),
            _span("gen.backward", t0 + 2_000, 5_000),
            _span("gen.update", t0 + 8_000, 1_000),
            _span("disc.backward", t0 + 10_000, 5_000),
            _span("disc.update", t0 + 16_000, 1_000),
        ]
        ev.kernel(t0 + 300, 30)
        ev.kernel(t0 + 2_500, 100)
        ev.kernel(t0 + 8_100, 8)
        ev.kernel(t0 + 10_500, 40)
        ev.kernel(t0 + 16_100, 2)
        ev.call("cudaMemcpyAsync", t0 + 20)
        ev.call("cudaStreamSynchronize", t0 + 30)
        ev.call("cuMemFree_v2", t0 + 3_000)
        ev.call("cudaEventSynchronize", t0 + 20_000)
        ev.call("cudaStreamSynchronize", t0 + 35_000)    # outside
    return ev


KNOWN = {
    "stft_device_ms.serve": (_serve_batch_trace, 8e-3),
    "encoder_device_ms.serve": (_serve_batch_trace, 10e-3),
    "vq_device_ms.serve": (_serve_batch_trace, 3e-3),
    "decoder_device_ms.serve": (_serve_batch_trace, 11e-3),
    "host_enqueue_ms.serve": (_serve_batch_trace, 4.0),
    "host_syncs_per_request": (_request_trace, 3),
    "backward_device_ms.adv": (_train_trace, 140e-3),
    "update_device_ms.adv": (_train_trace, 10e-3),
    "host_syncs_per_step.adv": (_train_trace, 3),
    "graph_hit_pct.request": (_replay_trace, 75.0),
    "graph_hit_pct.serve": (_replay_trace, 75.0),
}


@pytest.mark.parametrize("name", sorted(KNOWN))
def test_reader_reads_the_known_value(name):
    build, want = KNOWN[name]
    assert bench_run.reader(name)(build().run()) == pytest.approx(want)


@pytest.mark.parametrize("name", sorted(KNOWN))
def test_reader_reads_nothing_without_the_program_spans(name):
    """A program without spans (the benchmark's own spans only), a run on
    the CPU (no device operation) and a run without a trace."""
    build, _ = KNOWN[name]
    ev = build()
    ev.events = [e for e in ev.events if e["cat"] != "user_annotation"
                 or e["name"] in (WINDOW, UNIT)]
    ev.events.append(_span("esc.encode", 100, 1_000))
    read = bench_run.reader(name)
    assert read(ev.run()) is None
    assert read(build().run(device=False)) is None
    assert read(types.SimpleNamespace(traces=[], traced_units=0)) is None


@pytest.mark.parametrize("name", ["graph_hit_pct.request",
                                  "graph_hit_pct.serve"])
def test_graph_hits_read_nothing_without_replay_spans(name):
    """A program without stage graphs: codec calls, no ``codec.replay``."""
    assert bench_run.reader(name)(_request_trace().run()) is None


def test_the_serve_batch_stages_add_up_to_the_calls():
    run = _serve_batch_trace().run()
    stages = sum(bench_run.reader(n)(run) for n in (
        "stft_device_ms.serve", "encoder_device_ms.serve",
        "vq_device_ms.serve", "decoder_device_ms.serve"))
    calls = bench_spans.device_ms(run, "codec.encode", "codec.decode")
    assert stages == pytest.approx(calls)


@pytest.mark.parametrize("name,sync", [
    ("cudaStreamSynchronize", True), ("cudaDeviceSynchronize", True),
    ("cudaEventSynchronize", True), ("cuStreamSynchronize", True),
    ("cudaMemcpy", True), ("cudaMemcpy2D", True), ("cudaFree", True),
    ("cudaFreeHost", True), ("cuMemFree_v2", True),
    ("cudaMemcpyAsync", False), ("cudaMemcpy2DAsync", False),
    ("cudaLaunchKernel", False), ("cudaMalloc", False),
    ("cudaFreeAsync", False), ("cudaEventRecord", False),
    ("aten::copy_", False)])
def test_is_sync_names(name, sync):
    assert bench_spans.is_sync(name) is sync


def test_family_selector_and_merged_ranges():
    trace = Trace([_span(WINDOW, 0, 1_000), _span("vq.s0", 10, 100),
                   _span("vq.s12", 50, 200), _span("vqx", 400, 10),
                   _span("vq.s1", 600, 10)])
    def flat(selectors):
        return [t for r in bench_spans.ranges(trace, selectors) for t in r]
    assert flat(["vq.*"]) == pytest.approx([10e-6, 250e-6, 600e-6, 610e-6])
    assert flat(["vq.s1"]) == pytest.approx([600e-6, 610e-6])
    assert flat(["vq.s1", "vqx"]) == pytest.approx(
        [400e-6, 410e-6, 600e-6, 610e-6])
