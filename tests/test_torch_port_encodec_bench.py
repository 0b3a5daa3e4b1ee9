"""EnCodec's benchmark cell on the CPU: the port against the cell's plain
reference, the cell's comparison, its driver, its work count and its spans.

- ``portbench/reference/encodec.py`` (plain float32 torch, its LSTM a loop
  over time) and the port's ``Encodec`` get the same weights (the
  reference's ``init_weights`` from a seed); at two geometries the port's
  ``encode_codes`` gives the reference's codes, and ``decode_codes`` its
  waveform within 1e-5 of the widest sample: both run float32 on the CPU
  and differ only where ``nn.LSTM``'s kernel, the port's search without
  the residual's own norm and its summed codewords round otherwise, which
  moves no code at these sizes;
- the reference's LSTM matches ``nn.LSTM`` on the same weights within
  1e-5;
- ``check_serving`` reads ``code_gap`` 0 on the port's own codes and fails
  the cell's limits on a planted altered code and an altered waveform;
- ``portbench/drivers/encodec_serve_batch.py`` runs end to end through
  ``portbench/run.py::execute`` at a tiny size, correct, and stops at once
  on a program without ``encode_codes``;
- ``lstm_roofline.py``'s work count is pinned at the cell's shapes (60.4
  GFLOP, 0.901 ms) and its layer-runs are what hooks on the port's LSTMs
  see; the readers read a hand-built trace, where the LSTM's readers count
  two kernels that overlap once;
- under ``torch.profiler`` every operator of ``encode_codes`` /
  ``decode_codes`` lies under a stage span; with CUDA's graph calls
  replaced by ``tests/test_torch_port_graphs.py``'s stand-ins, a shape's
  first call runs eagerly, its second captures one graph a stage span
  and its third replays them inside ``codec.replay``; the codec's graphs
  pass ``StageGraphs.of``'s gate as ``Codec``'s do;
- at full width the port's state dict has the release's 156 keys, the
  reference's keys and shapes.

Imports no JAX.
"""

import ast
import importlib.util
import json
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from esc_tpu_torch.baselines.encodec import Encodec, EncodecModule
from esc_tpu_torch.baselines.encodec.layers import SLSTM
from esc_tpu_torch.utils import graphs
from portbench import run as bench_run
from portbench.drivers.common import check_serving
from portbench.harness import Run
from portbench.reference import encodec as ref_encodec
from portbench.reference.weights import seeded_generator
from portbench.signals import speech_like
from portbench.trace import UNIT, WINDOW, Trace


def _sibling(name):
    """The test module ``name`` beside this file, loaded by its path: the
    card's tests run with ``--noconftest``, where ``tests`` may not
    resolve to this directory."""
    path = Path(__file__).with_name(f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_sibling_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# CUDA's graph calls replaced by stand-ins for a run on the CPU
stand_ins = _sibling("test_torch_port_graphs").stand_ins

WORKLOAD = "encodec-24khz-24kbps.serve-batch"
CONFIG = json.loads((bench_run.BENCH_DIR / "configs"
                     / "encodec-24khz-24kbps.json").read_text())
SEED = 2 ** 31 + 23023          # larger than 32 signed bits hold
# the published ratios and SEANet at small widths (4 codebooks of 32 at
# 75 frames/s: 1.5 kbps), and a second geometry
SMALL = dict(CONFIG, Encodec=dict(CONFIG["Encodec"], n_filters=4,
                                  dimension=16, n_q=4, bins=32))
OTHER = dict(CONFIG, Encodec=dict(CONFIG["Encodec"], n_filters=8,
                                  dimension=12, ratios=[3, 2], n_q=3,
                                  bins=64))
STAGES = ("codec.upload", "encoder.", "vq.", "decoder.")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for the module (the suite's workers share the
    host's cores), restored after it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _bandwidth(cfg):
    """The bandwidth at which every codebook of ``cfg`` is sent."""
    c = cfg["Encodec"]
    return c["n_q"] * c["sample_rate"] / np.prod(c["ratios"]) \
        * np.log2(c["bins"]) / 1000


def _pair(cfg, seed=SEED):
    """(reference, port) with the same weights, and the generator."""
    gen = seeded_generator(seed, "cpu")
    ref = ref_encodec.Encodec(**cfg["Encodec"], **cfg["SEANet"])
    ref_encodec.init_weights(ref, gen)
    port = Encodec(bandwidth=_bandwidth(cfg), device="cpu", **cfg["Encodec"])
    port.load_state_dict(ref.state_dict())
    return ref, port, gen


def _metric_module(name):
    path = bench_run.BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"test_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- the port against the reference ----------------------------------------

@pytest.mark.parametrize("cfg,batch,frames", [(SMALL, 2, 15), (OTHER, 3, 40)],
                         ids=["published-ratios", "other"])
def test_port_matches_the_plain_reference(cfg, batch, frames):
    ref, port, gen = _pair(cfg)
    hop = int(np.prod(cfg["Encodec"]["ratios"]))
    x = speech_like(gen, batch, frames * hop, "cpu")
    want = ref.encode(x)
    got = port.encode_codes(x.numpy())
    assert got.shape == want.shape == (batch, cfg["Encodec"]["n_q"], frames)
    assert torch.equal(got.long(), want)
    y = ref.decode(want)
    wave = port.decode_codes(got.numpy())
    assert wave.shape == y.shape == (batch, frames * hop)
    assert float((wave - y).abs().max() / y.abs().max()) <= 1e-5


def test_serving_pair_is_the_codecs_own_encode_and_decode():
    assert Encodec.encode_codes is Encodec.encode
    assert Encodec.decode_codes is Encodec.decode
    _, port, gen = _pair(SMALL)
    x = speech_like(gen, 2, 15 * 320, "cpu")
    codes = port.encode_codes(x)
    assert torch.equal(codes, port.encode(x))
    assert codes.dtype == torch.int32
    assert torch.equal(port.decode_codes(codes), port.decode(codes))


def test_reference_lstm_matches_nn_lstm():
    gen = seeded_generator(SEED, "cpu")
    ours = ref_encodec.LSTM(16, 2)
    ref_encodec.init_weights(ours, gen)
    theirs = torch.nn.LSTM(16, 16, 2)
    theirs.load_state_dict(ours.state_dict())
    x = torch.randn(20, 3, 16, generator=gen)
    with torch.no_grad():
        want, _ = theirs(x)
        got = ours(x)
    assert float((got - want).abs().max()) <= 1e-5
    assert float(want.abs().max()) > 0.05


def test_reference_is_plain_float32_torch():
    tree = ast.parse((bench_run.BENCH_DIR / "reference" / "encodec.py")
                     .read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            tops.add(node.module.split(".")[0])
    assert tops <= {"__future__", "math", "warnings", "torch"}, tops
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    ref, _, _ = _pair(SMALL)
    assert not any(isinstance(m, torch.nn.LSTM) for m in ref.modules())
    assert all(p.dtype == torch.float32 for p in ref.parameters())


def test_reference_init_has_the_programs_distributions():
    ref, _, _ = _pair(SMALL)
    sd = ref.state_dict()
    assert all(bool((v == 1).all()) for k, v in sd.items()
               if k.endswith("weight_g"))
    assert all(bool((v == 0).all()) for k, v in sd.items()
               if k.endswith(".bias"))
    lstm = [v for k, v in sd.items() if ".lstm." in k]
    bound = 1 / np.sqrt(SMALL["Encodec"]["n_filters"] * 2 ** 4)
    assert lstm and all(float(v.abs().max()) <= bound for v in lstm)
    embed = torch.cat([v for k, v in sd.items() if k.endswith(".embed")])
    assert abs(float(embed.std()) - 1) < 0.1


def test_full_width_state_dict_is_the_releases_156_keys():
    port = EncodecModule().state_dict()
    with torch.device("meta"):
        ref = ref_encodec.Encodec(**CONFIG["Encodec"],
                                  **CONFIG["SEANet"]).state_dict()
    assert len(port) == 156
    assert {k: tuple(v.shape) for k, v in port.items()} == \
        {k: tuple(v.shape) for k, v in ref.items()}
    assert sum(v.numel() for v in port.values()) == pytest.approx(
        19.05e6, rel=1e-3)


# -- the cell's comparison ---------------------------------------------------

def _served():
    ref, port, gen = _pair(SMALL)
    x = speech_like(gen, 2, 15 * 320, "cpu")
    codes = port.encode_codes(x)
    wave = port.decode_codes(codes)
    return ref, port, x.numpy(), codes.numpy(), wave.numpy()


def _judge(ref, samples):
    run = Run(workload=WORKLOAD, config=SMALL, traffic={}, seed=SEED,
              seconds=0, trace=False, device="cpu", t_start=0.0)
    check_serving(run, ref, samples)
    return run


def test_check_reads_nothing_on_the_ports_own_outputs():
    ref, _, x, codes, wave = _served()
    run = _judge(ref, [(x, codes, wave)])
    assert run.correct, run.checks
    assert run.checks["code_gap"]["value"] == 0.0
    assert set(run.checks) == {"code_gap", "wave_gap"}


@pytest.mark.parametrize("fault", ["code", "wave"])
def test_check_fails_a_planted_fault(fault):
    ref, port, x, codes, wave = _served()
    if fault == "code":
        codes = codes.copy()
        codes[0, 2, 5] = (codes[0, 2, 5] + 1) % SMALL["Encodec"]["bins"]
        wave = port.decode_codes(codes).numpy()
    else:
        wave = wave.copy()
        wave[0, wave.shape[1] // 2] += 0.5 * np.abs(wave).max()
    run = _judge(ref, [(x, codes, wave)])
    assert not run.correct
    c = run.checks[f"{fault}_gap"]
    assert c["value"] > c["limit"]


# -- the driver ------------------------------------------------------------

TINY_TRAFFIC = dict(driver="encodec_serve_batch", batch=2, length=15 * 320,
                    bandwidth=1.5, depth=2, pool=2, check=2, trace_units=2)


@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
def test_driver_runs_end_to_end_and_is_correct(trace):
    torch.set_num_threads(1)
    bench = bench_run.load_bench()
    run, metrics = bench_run.execute(
        bench, WORKLOAD, SEED, 0.3, trace, device="cpu", config=SMALL,
        traffic=dict(TINY_TRAFFIC))
    assert run.correct, run.checks
    assert set(run.checks) == {"code_gap", "wave_gap"}
    assert run.attempted == len(run.units) > 0 and run.failed == 0
    assert any(n.startswith("distinct codes a stage") for n in run.notes)
    names = {m["name"] for m in bench_run.metrics_of(bench, WORKLOAD, trace)}
    if not trace:
        assert set(metrics) == names == {"audio_s_per_s", "setup_s"}
        assert metrics["audio_s_per_s"]["value"] > 0
    else:
        assert run.traced_units == 2 and run.traces
        assert run.unit_flops > 0
        # no device on the CPU: only the host-clock share is read
        assert set(metrics) == {"mfu_pct.encodec"}
    line = bench_run.result_line(run, metrics, {"platform": "cpu"})
    json.dumps(line)


def test_driver_refuses_a_length_the_hop_does_not_divide():
    bench = bench_run.load_bench()
    with pytest.raises(ValueError, match="hop"):
        bench_run.execute(bench, WORKLOAD, SEED, 0.1, False, device="cpu",
                          config=SMALL, traffic=dict(TINY_TRAFFIC,
                                                     length=3000))


def test_driver_stops_at_once_on_a_program_without_the_serving_pair(
        monkeypatch):
    monkeypatch.delattr(Encodec, "encode_codes")
    bench = bench_run.load_bench()
    with pytest.raises(SystemExit, match="encode_codes"):
        bench_run.execute(bench, WORKLOAD, SEED, 0.1, False, device="cpu",
                          config=SMALL, traffic=dict(TINY_TRAFFIC))


def test_cell_files_hold_together():
    bench = bench_run.load_bench()
    cell = bench_run.cell_of(bench, WORKLOAD)
    assert cell["chips"] == 1 and len(cell["why"]) <= 200
    cfg = next(c for c in bench["configs"] if c["name"] == cell["config"])
    assert cfg["reduced"] == [] and cfg["source"].startswith("https://")
    traffic = json.loads((bench_run.BENCH_DIR / "traffic"
                          / f"{cell['traffic']}.json").read_text())
    assert traffic["driver"] == "encodec_serve_batch"
    assert traffic["length"] % int(np.prod(CONFIG["Encodec"]["ratios"])) == 0
    assert traffic["bandwidth"] == _bandwidth(CONFIG) == 24.0
    limits = json.loads((bench_run.BENCH_DIR / "limits"
                         / f"{WORKLOAD}.json").read_text())
    assert set(limits["limits"]) == {"code_gap", "wave_gap"}
    for name, lim in limits["limits"].items():
        r = limits["readings"][name]
        assert r["lower"] < lim < r["upper"], name
    per_layer = [m for m in bench["per_layer"]
                 if WORKLOAD in m.get("workloads", [])]
    assert {m["name"] for m in per_layer} == {
        "encoder_device_ms.encodec", "vq_device_ms.encodec",
        "decoder_device_ms.encodec", "lstm_device_ms.encodec",
        "lstm_roofline", "mfu_pct.encodec", "device_idle_pct.encodec",
        "graph_hit_pct.encodec", "host_enqueue_ms.encodec"}
    for m in per_layer:
        assert m["moves"] == "audio_s_per_s"
        assert callable(bench_run.reader(m["name"]))
    e2e = {m["name"] for m in bench_run.metrics_of(bench, WORKLOAD, False)}
    assert e2e == {"audio_s_per_s", "setup_s"}


# -- the work count ------------------------------------------------------------

def test_lstm_work_at_the_published_shapes():
    """4 layer-runs of 3,600 tokens at 512: 60.4 GFLOP, 0.901 ms by
    operations."""
    lstm = _metric_module("lstm_roofline")
    traffic = {"batch": 16, "length": 72000}
    assert lstm.layer_runs(CONFIG, traffic) == [(3600, 512, 512)] * 4
    calls = lstm.calls(CONFIG, traffic)
    assert sum(f for _, f in calls) == pytest.approx(60.398e9, rel=1e-4)
    bounds = [max(b / 3.35e12, f / 67e12) for b, f in calls]
    assert all(f / 67e12 > b / 3.35e12 for b, f in calls)
    assert sum(bounds) * 1e3 == pytest.approx(0.9015, rel=1e-4)


@pytest.mark.parametrize("cfg,frames", [(SMALL, 15), (OTHER, 7)],
                         ids=["published-ratios", "other"])
def test_layer_runs_are_what_the_program_runs(cfg, frames):
    lstm = _metric_module("lstm_roofline")
    _, port, gen = _pair(cfg)
    B, L = 2, frames * int(np.prod(cfg["Encodec"]["ratios"]))
    seen = []
    hooks = [m.register_forward_hook(
        lambda m, inp, out: seen.extend(
            [(inp[0].shape[0] * inp[0].shape[2], m.lstm.input_size,
              m.lstm.hidden_size)] * m.lstm.num_layers))
        for m in port.module.modules() if isinstance(m, SLSTM)]
    port.decode_codes(port.encode_codes(speech_like(gen, B, L, "cpu")))
    for h in hooks:
        h.remove()
    assert seen == lstm.layer_runs(cfg, {"batch": B, "length": L})


# -- the spans ---------------------------------------------------------------

def _chain(event):
    out, p = [], event.cpu_parent
    while p is not None:
        out.append(p.name)
        p = p.cpu_parent
    return out


def _children(events, parent):
    return [e.name for e in sorted(events, key=lambda e: e.time_range.start)
            if e.cpu_parent is not None and e.cpu_parent.name == parent
            and not e.name.startswith("aten::")]


def test_stage_spans_cover_encode_and_decode():
    _, port, gen = _pair(SMALL)
    x = speech_like(gen, 2, 15 * 320, "cpu").numpy()
    port.decode_codes(port.encode_codes(x))           # off the profiler
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        codes = port.encode_codes(x)
        port.decode_codes(codes.numpy())
    events = prof.events()
    top = [e.name for e in events if e.cpu_parent is None
           and not e.name.startswith("aten::")]
    assert top == ["codec.encode", "codec.decode"]
    assert _children(events, "codec.encode") == (
        ["codec.upload", "encoder.embed"]
        + [f"encoder.s{i}" for i in range(4)]
        + ["encoder.lstm", "encoder.post", "vq.s0"])
    # host codes: made a tensor, then copied to the device
    assert _children(events, "codec.decode") == (
        ["codec.upload"] * 2 + ["vq.s0", "decoder.pre", "decoder.lstm"]
        + [f"decoder.s{i}" for i in range(4)] + ["decoder.post"])
    lstm = [e for e in events if e.name == "aten::lstm"]
    assert [_chain(e)[0] for e in lstm] == ["encoder.lstm", "decoder.lstm"]
    uncovered = [(e.name, _chain(e)) for e in events
                 if e.name.startswith("aten::")
                 and {"codec.encode", "codec.decode"} & set(_chain(e))
                 and not any(c.startswith(STAGES) for c in _chain(e))]
    assert uncovered == []


def test_spans_leave_the_outputs_as_they_were():
    _, port, gen = _pair(SMALL)
    x = speech_like(gen, 2, 15 * 320, "cpu")
    codes, wave = port.encode(x), port(x, 24000)
    with profile(activities=[ProfilerActivity.CPU]):
        assert torch.equal(port.encode(x), codes)
        assert torch.equal(port(x, 24000), wave)


def _lstm_trace():
    """Two batches, hand-built: encoder.lstm and decoder.lstm kernels of 3
    + 5 us a batch, an encoder conv of 2 us, a vq search of 4 us, a
    decoder conv of 6 us and a 40 us kernel outside every span; times in
    microseconds."""
    events = [{"ph": "X", "cat": "user_annotation", "name": n, "ts": 0,
               "dur": 100_000, "pid": 1, "tid": 1} for n in (WINDOW, UNIT)]
    corr = 0
    for b in range(2):
        t0 = b * 10_000
        for name, ts, dur in (("encoder.s0", t0, 100),
                              ("encoder.lstm", t0 + 100, 200),
                              ("vq.s0", t0 + 300, 100),
                              ("decoder.lstm", t0 + 500, 200),
                              ("decoder.s1", t0 + 700, 100)):
            events.append({"ph": "X", "cat": "user_annotation",
                           "name": name, "ts": ts, "dur": dur, "pid": 1,
                           "tid": 1})
        for at, dur, name in ((t0 + 50, 2, "conv"), (t0 + 150, 3, "lstm"),
                              (t0 + 350, 4, "gemm"), (t0 + 560, 5, "lstm"),
                              (t0 + 750, 6, "convT"), (t0 + 5_000, 40, "x")):
            corr += 1
            events.append({"ph": "X", "cat": "cuda_runtime",
                           "name": "cudaLaunchKernel", "ts": at, "dur": 2,
                           "pid": 1, "tid": 1,
                           "args": {"correlation": corr}})
            events.append({"ph": "X", "cat": "kernel", "name": name,
                           "ts": 90_000 - corr * 100, "dur": dur, "pid": 1,
                           "tid": 7, "args": {"correlation": corr}})
    return events


def test_readers_on_a_hand_built_trace():
    traffic = {"batch": 16, "length": 72000}
    run = types.SimpleNamespace(traces=[Trace(_lstm_trace())],
                                traced_units=2, config=CONFIG,
                                traffic=traffic)
    read = {n: _metric_module(n).read for n in (
        "encoder_device_ms.encodec", "vq_device_ms.encodec",
        "decoder_device_ms.encodec", "lstm_device_ms.encodec",
        "lstm_roofline")}
    assert read["encoder_device_ms.encodec"](run) == pytest.approx(5e-3)
    assert read["vq_device_ms.encodec"](run) == pytest.approx(4e-3)
    assert read["decoder_device_ms.encodec"](run) == pytest.approx(11e-3)
    assert read["lstm_device_ms.encodec"](run) == pytest.approx(8e-3)
    least = sum(max(b / 3.35e12, f / 67e12) for b, f in
                _metric_module("lstm_roofline").calls(CONFIG, traffic))
    assert read["lstm_roofline"](run) == pytest.approx(100 * least / 8e-6)
    # no program spans (the parent's EnCodec), or no EnCodec at all
    bare = [e for e in _lstm_trace() if e.get("cat") != "user_annotation"
            or e["name"] in (WINDOW, UNIT)]
    run.traces = [Trace(bare)]
    assert all(r(run) is None for r in read.values())
    run.traces, run.config = [Trace(_lstm_trace())], {"DAC": {}}
    assert all(r(run) is None for r in read.values())


def test_lstm_readers_count_overlapping_kernels_once():
    """A second encoder.lstm kernel of 3 us a batch that starts 1 us into
    the first (3 us), as cuDNN runs its recurrence's kernels side by side:
    the LSTM's busy time grows by 1 us a batch, not 3, and the roofline's
    denominator with it; the encoder's device ms, a sum, grows by 3."""
    events = _lstm_trace()
    first = [e for e in events if e.get("cat") == "kernel"
             and e["name"] == "lstm"][::2]      # encoder.lstm's, a batch
    corr = 1000
    for b, k in enumerate(first):
        corr += 1
        events.append({"ph": "X", "cat": "cuda_runtime",
                       "name": "cudaLaunchKernel", "ts": b * 10_000 + 160,
                       "dur": 2, "pid": 1, "tid": 1,
                       "args": {"correlation": corr}})
        events.append({"ph": "X", "cat": "kernel", "name": "lstm",
                       "ts": k["ts"] + 1, "dur": 3, "pid": 1, "tid": 8,
                       "args": {"correlation": corr}})
    traffic = {"batch": 16, "length": 72000}
    run = types.SimpleNamespace(traces=[Trace(events)], traced_units=2,
                                config=CONFIG, traffic=traffic)
    assert _metric_module("lstm_device_ms.encodec").read(run) == \
        pytest.approx(9e-3)
    assert _metric_module("encoder_device_ms.encodec").read(run) == \
        pytest.approx(8e-3)
    least = sum(max(b / 3.35e12, f / 67e12) for b, f in
                _metric_module("lstm_roofline").calls(CONFIG, traffic))
    assert _metric_module("lstm_roofline").read(run) == \
        pytest.approx(100 * least / 9e-6)


ENCODE_STAGES = (["encoder.embed"] + [f"encoder.s{i}" for i in range(4)]
                 + ["encoder.lstm", "encoder.post", "vq.s0"])
DECODE_STAGES = (["vq.s0", "decoder.pre", "decoder.lstm"]
                 + [f"decoder.s{i}" for i in range(4)] + ["decoder.post"])


def test_no_stage_graphs_on_the_cpu():
    _, port, _ = _pair(SMALL)
    assert port._graphs() is None


def test_stage_graphs_gate_is_the_codecs():
    """``StageGraphs.of``'s gate, as ``Codec``'s: a CUDA device and eval
    mode; one holder kept on the codec, made anew for a new module."""
    _, port, _ = _pair(SMALL)
    port.device = torch.device("cuda")      # the gate alone, no card used
    sg = port._graphs()
    assert isinstance(sg, graphs.StageGraphs) and port._graphs() is sg
    assert port._stage_graphs is sg and sg.module is port.module
    port.module.train()
    assert port._graphs() is None
    port.module = EncodecModule(**SMALL["Encodec"]).eval()
    assert port._graphs() is not sg
    assert port._graphs().module is port.module


def test_serving_calls_capture_and_replay_stage_graphs(stand_ins,
                                                       monkeypatch):
    _, port, gen = _pair(SMALL)
    sg = graphs.StageGraphs(port.module, port.device)
    monkeypatch.setattr(port, "_graphs", lambda: sg)
    x = speech_like(gen, 2, 15 * 320, "cpu")
    first = port.encode_codes(x.numpy())
    assert stand_ins == [] and not sg.chains
    second = port.encode_codes(x)
    key = ("encode", (2, 4800), 4)
    assert sg.chains[key].names == ENCODE_STAGES
    assert torch.equal(first, second)
    wave = [port.decode_codes(second) for _ in range(2)]
    key = ("decode", (2, 4, 15), torch.int32)
    assert sg.chains[key].names == DECODE_STAGES
    assert torch.equal(wave[0], wave[1])
    assert stand_ins == ["capture"] * 16
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        third = port.encode_codes(x)
        port.decode_codes(third.numpy())
    # the stand-in replays launch nothing: the capture's outputs come back
    assert stand_ins[16:] == ["replay"] * 16
    assert torch.equal(third, second) and third is not second
    events = prof.events()
    # the input's copy into the chain's buffer, then the replay; a host
    # array of codes is made a tensor first, for its dtype
    assert _children(events, "codec.encode") == ["codec.upload",
                                                 "codec.replay"]
    assert _children(events, "codec.decode") == ["codec.upload"] * 2 + [
        "codec.replay"]
    assert _children(events, "codec.replay") == ENCODE_STAGES + DECODE_STAGES


@pytest.mark.cuda
def test_replay_equals_eager_on_the_card():
    """At full width on 4 x 1 s, with cuDNN's deterministic algorithms:
    the replayed serving calls give the eager module's codes and
    waveform bit for bit, and a result outlives the next call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(0)
    warm, x = (0.1 * rng.standard_normal((2, 4, 24000))).astype(np.float32)
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=False):
        codec = Encodec(bandwidth=24.0, seed=3, device="cuda")
        for _ in range(2):                      # eager, then the capture
            codec.decode_codes(codec.encode_codes(warm))
        assert len(codec._graphs().chains) == 2
        codes = codec.encode_codes(x)
        kept = codes.clone()
        eager = codec.module.encode(torch.as_tensor(x).cuda(), 32)
        assert torch.equal(codes, eager)
        wave = codec.decode_codes(eager)
        assert torch.equal(wave, codec.module.decode(eager))
        codec.encode_codes(warm)
        assert torch.equal(codes, kept)
