"""The DAC's benchmark cell on the CPU: the port against the cell's plain
reference, the cell's comparison, its driver, its call counts and its spans.

- ``portbench/reference/dac.py`` (plain float32 torch) and the port's
  ``DAC`` get the same weights (``fill`` from a seed, then every snake's
  alpha 1); at two geometries the port's ``encode_codes`` gives the
  reference's codes, and ``decode_codes`` its waveform within 1e-5 of the
  widest sample: both run the same float32 operations on the CPU and differ
  only where the port's L2 normalisation and argmin round otherwise, which
  moves no code at these sizes;
- ``check_serving`` reads ``code_gap`` 0 on the port's own codes and fails
  the cell's limits on a planted altered code and an altered waveform;
- ``portbench/drivers/dac_serve_batch.py`` runs end to end through
  ``portbench/run.py::execute`` at a tiny size, correct;
- the call lists of ``snake_roofline.py`` and
  ``codebook_argmin_roofline.dac.py`` are what forward hooks on the snakes
  and a count of the argmin wrapper's calls find, at the published rates;
- under ``torch.profiler`` every operator of ``encode_codes`` /
  ``decode_codes`` lies under a stage span, each snake in ``act.snake``;
  ``DataParallel``'s exchange over two gloo ranks runs in ``dp.allreduce``.

Imports no JAX.
"""

import ast
import importlib.util
import json
import os
import socket
import types

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from torch.profiler import ProfilerActivity, profile

from esc_tpu_torch.baselines.dac import DAC
from esc_tpu_torch.baselines.dac import quantize as dac_quantize
from esc_tpu_torch.baselines.dac.layers import Snake1d
from esc_tpu_torch.ops.kernels import codebook_argmin_plain
from portbench import run as bench_run
from portbench.drivers.common import check_serving
from portbench.harness import Run
from portbench.reference import dac as ref_dac
from portbench.reference.weights import fill, seeded_generator
from portbench.signals import speech_like
from portbench.trace import UNIT, WINDOW, Trace

WORKLOAD = "dac-16khz-9kbps.serve-batch"
CONFIG = json.loads((bench_run.BENCH_DIR / "configs"
                     / "dac-16khz-9kbps.json").read_text())["DAC"]
SEED = 2 ** 31 + 12345          # larger than 32 signed bits hold
# the published rates at small widths, and a second geometry
SMALL = dict(CONFIG, encoder_dim=4, decoder_dim=32, n_codebooks=6,
             codebook_size=64)
OTHER = dict(sample_rate=16000, encoder_dim=8, encoder_rates=[2, 3],
             decoder_dim=24, decoder_rates=[3, 2], n_codebooks=4,
             codebook_size=32, codebook_dim=4, quantizer_dropout=0.0)
STAGES = ("codec.upload", "encoder.", "vq.", "decoder.")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for the module (the suite's workers share the
    host's cores), restored after it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _pair(cfg, seed=SEED):
    """(reference, port) with the same weights, and the generator."""
    gen = seeded_generator(seed, "cpu")
    ref = ref_dac.DAC(**cfg)
    fill(ref, gen)
    ref_dac.snake_alphas_to_one(ref)
    port = DAC(device="cpu", **cfg)
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

@pytest.mark.parametrize("cfg,batch,frames", [(SMALL, 2, 12), (OTHER, 3, 40)],
                         ids=["published-rates", "other"])
def test_port_matches_the_plain_reference(cfg, batch, frames):
    ref, port, gen = _pair(cfg)
    hop = int(np.prod(cfg["encoder_rates"]))
    x = speech_like(gen, batch, frames * hop, "cpu")
    want = ref.encode(x)
    got = port.encode_codes(x)
    assert got.shape == want.shape == (batch, cfg["n_codebooks"], frames)
    assert torch.equal(got.long(), want)
    y = ref.decode(want)
    wave = port.decode_codes(got)
    assert wave.shape == y.shape
    assert float((wave - y).abs().max() / y.abs().max()) <= 1e-5


def test_reference_is_plain_float32_torch():
    tree = ast.parse((bench_run.BENCH_DIR / "reference" / "dac.py")
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
    alphas = [m.alpha for m in ref.modules()
              if isinstance(m, ref_dac.Snake1d)]
    assert len(alphas) == 58 and all(bool((a == 1).all()) for a in alphas)
    assert all(p.dtype == torch.float32 for p in ref.parameters())


# -- the cell's comparison ---------------------------------------------------

def _served():
    ref, port, gen = _pair(SMALL)
    x = speech_like(gen, 2, 12 * 320, "cpu")
    codes = port.encode_codes(x)
    wave = port.decode_codes(codes)
    return ref, port, x.numpy(), codes.numpy(), wave.numpy()


def _judge(ref, samples):
    run = Run(workload=WORKLOAD, config={"DAC": SMALL}, traffic={},
              seed=SEED, seconds=0, trace=False, device="cpu", t_start=0.0)
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
        codes[0, 3, 5] = (codes[0, 3, 5] + 1) % SMALL["codebook_size"]
        wave = port.decode_codes(codes).numpy()
    else:
        wave = wave.copy()
        wave[0, wave.shape[1] // 2] += 0.5 * np.abs(wave).max()
    run = _judge(ref, [(x, codes, wave)])
    assert not run.correct
    c = run.checks[f"{fault}_gap"]
    assert c["value"] > c["limit"]


# -- the driver ------------------------------------------------------------

TINY_TRAFFIC = dict(driver="dac_serve_batch", batch=2, length=12 * 320,
                    n_quantizers=6, depth=2, pool=2, check=2, trace_units=2)


@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
def test_driver_runs_end_to_end_and_is_correct(trace):
    torch.set_num_threads(1)
    bench = bench_run.load_bench()
    run, metrics = bench_run.execute(
        bench, WORKLOAD, SEED, 0.3, trace, device="cpu",
        config={"DAC": SMALL}, traffic=dict(TINY_TRAFFIC))
    assert run.correct, run.checks
    assert set(run.checks) == {"code_gap", "wave_gap"}
    assert run.attempted == len(run.units) > 0 and run.failed == 0
    names = {m["name"] for m in bench_run.metrics_of(bench, WORKLOAD, trace)}
    if not trace:
        assert set(metrics) == names == {"audio_s_per_s", "setup_s"}
        assert metrics["audio_s_per_s"]["value"] > 0
    else:
        assert run.traced_units == 2 and run.traces
        assert run.unit_flops > 0
        # no device on the CPU: only the host-clock share is read
        assert set(metrics) == {"mfu_pct.dac"}
    line = bench_run.result_line(run, metrics, {"platform": "cpu"})
    json.dumps(line)


def test_driver_refuses_a_length_the_hop_does_not_divide():
    bench = bench_run.load_bench()
    with pytest.raises(ValueError, match="hop"):
        bench_run.execute(bench, WORKLOAD, SEED, 0.1, False, device="cpu",
                          config={"DAC": SMALL},
                          traffic=dict(TINY_TRAFFIC, length=3000))


def test_cell_files_hold_together():
    bench = bench_run.load_bench()
    cell = bench_run.cell_of(bench, WORKLOAD)
    assert cell["chips"] == 1
    cfg = next(c for c in bench["configs"] if c["name"] == cell["config"])
    assert cfg["reduced"] == [] and cfg["source"].startswith("https://")
    traffic = json.loads((bench_run.BENCH_DIR / "traffic"
                          / f"{cell['traffic']}.json").read_text())
    assert traffic["driver"] == "dac_serve_batch"
    assert traffic["length"] % int(np.prod(CONFIG["encoder_rates"])) == 0
    assert traffic["n_quantizers"] == CONFIG["n_codebooks"] == 18
    limits = json.loads((bench_run.BENCH_DIR / "limits"
                         / f"{WORKLOAD}.json").read_text())
    for name, lim in limits["limits"].items():
        r = limits["readings"][name]
        assert r["lower"] < lim < r["upper"], name
    per_layer = [m for m in bench["per_layer"]
                 if WORKLOAD in m.get("workloads", [])]
    assert {m["name"] for m in per_layer} == {
        "encoder_device_ms.dac", "vq_device_ms.dac", "decoder_device_ms.dac",
        "snake_roofline", "codebook_argmin_roofline.dac", "mfu_pct.dac",
        "device_idle_pct.dac"}
    for m in per_layer:
        assert m["moves"] == "audio_s_per_s"
        assert callable(bench_run.reader(m["name"]))


# -- the call counts -------------------------------------------------------

def test_published_counts():
    """58 snakes and 18 searches of 2,400 x 1024 x 8 a batch of 16 x 3 s;
    2.33 G snake elements."""
    snake = _metric_module("snake_roofline")
    argmin = _metric_module("codebook_argmin_roofline.dac")
    calls = snake.snake_calls(CONFIG, 48000)
    assert len(calls) == 58
    assert 16 * sum(C * T for C, T in calls) == pytest.approx(2.33e9,
                                                             rel=0.01)
    assert argmin.argmin_calls(CONFIG, 16, 48000) == [(2400, 1024, 8)] * 18


@pytest.mark.parametrize("frames", [12, 7])
def test_call_lists_are_what_the_program_runs(frames, monkeypatch):
    snake = _metric_module("snake_roofline")
    argmin = _metric_module("codebook_argmin_roofline.dac")
    _, port, gen = _pair(SMALL)
    B, L = 2, frames * 320
    x = speech_like(gen, B, L, "cpu")
    seen_snake, seen_argmin = [], []
    hooks = [m.register_forward_hook(
        lambda m, inp, out: seen_snake.append(tuple(inp[0].shape)))
        for m in port.module.modules() if isinstance(m, Snake1d)]

    def counted(z, cb):
        seen_argmin.append((z.shape[0], cb.shape[0], z.shape[1]))
        return codebook_argmin_plain(z, cb)
    monkeypatch.setattr(dac_quantize, "codebook_argmin", counted)
    port.decode_codes(port.encode_codes(x))
    for h in hooks:
        h.remove()
    assert seen_snake == [(B, C, T) for C, T in snake.snake_calls(SMALL, L)]
    assert seen_argmin == argmin.argmin_calls(SMALL, B, L)
    traffic = {"batch": B, "length": L}
    nbytes = sum(b for b, _ in snake.calls({"DAC": SMALL}, traffic))
    assert nbytes == 4 * sum(2 * B * C * T + C for _, C, T in seen_snake)


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
    x = speech_like(gen, 2, 12 * 320, "cpu").numpy()
    port.decode_codes(port.encode_codes(x))           # off the profiler
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        port.decode_codes(port.encode_codes(x))
    events = prof.events()
    top = [e.name for e in events if e.cpu_parent is None
           and not e.name.startswith("aten::")]
    assert top == ["codec.encode", "codec.decode"]
    assert _children(events, "codec.encode") == (
        ["codec.upload", "encoder.embed"]
        + [f"encoder.s{i}" for i in range(4)] + ["encoder.post", "vq.s0"])
    assert _children(events, "codec.decode") == (
        ["codec.upload", "vq.s0", "decoder.pre"]
        + [f"decoder.s{i}" for i in range(4)] + ["decoder.post"])
    snakes = [e for e in events if e.name == "act.snake"]
    assert len(snakes) == 58
    assert sum("codec.encode" in _chain(e) for e in snakes) == 29
    for e in snakes:
        assert _chain(e)[0].startswith(("encoder.", "decoder.")), _chain(e)
    uncovered = [(e.name, _chain(e)) for e in events
                 if e.name.startswith("aten::")
                 and {"codec.encode", "codec.decode"} & set(_chain(e))
                 and not any(c.startswith(STAGES) for c in _chain(e))]
    assert uncovered == []


def _snake_trace():
    """Two batches, hand-built: act.snake kernels of 3 + 5 us a batch
    (one launched in a nested span), one 40 us kernel outside; a
    codebook_argmin kernel of 2 us a batch; times in microseconds."""
    events = [{"ph": "X", "cat": "user_annotation", "name": n, "ts": 0,
               "dur": 100_000, "pid": 1, "tid": 1} for n in (WINDOW, UNIT)]
    corr = 0
    for b in range(2):
        t0 = b * 10_000
        for name, ts, dur in (("encoder.s0", t0, 900),
                              ("act.snake", t0 + 100, 200),
                              ("act.snake", t0 + 500, 200),
                              ("act.snake", t0 + 550, 50)):
            events.append({"ph": "X", "cat": "user_annotation",
                           "name": name, "ts": ts, "dur": dur, "pid": 1,
                           "tid": 1})
        for at, dur, name in ((t0 + 150, 3, "sin"), (t0 + 560, 5, "mul"),
                              (t0 + 800, 2, "codebook_argmin"),
                              (t0 + 5_000, 40, "conv")):
            corr += 1
            events.append({"ph": "X", "cat": "cuda_runtime",
                           "name": "cudaLaunchKernel", "ts": at, "dur": 2,
                           "pid": 1, "tid": 1,
                           "args": {"correlation": corr}})
            events.append({"ph": "X", "cat": "kernel", "name": name,
                           "ts": 90_000 - corr * 100, "dur": dur, "pid": 1,
                           "tid": 7, "args": {"correlation": corr}})
    return events


def test_snake_and_argmin_rooflines_read_a_hand_built_trace():
    snake = _metric_module("snake_roofline")
    argmin = _metric_module("codebook_argmin_roofline.dac")
    traffic = {"batch": 16, "length": 48000}
    run = types.SimpleNamespace(traces=[Trace(_snake_trace())],
                                traced_units=2, config={"DAC": CONFIG},
                                traffic=traffic)
    least = sum(max(b / 3.35e12, f / 67e12)
                for b, f in snake.calls(run.config, traffic))
    assert snake.read(run) == pytest.approx(100 * least / 8e-6)
    least = sum(max(b / 3.35e12, f / 67e12)
                for b, f in argmin.calls(run.config, traffic))
    assert argmin.read(run) == pytest.approx(100 * least * 2 / 4e-6)
    assert _metric_module("encoder_device_ms.dac").read(run) == \
        pytest.approx(8e-3 + 2e-3)
    # no program spans (the parent's DAC), or no DAC at all: nothing read
    bare = [e for e in _snake_trace() if e["name"] not in (
        "act.snake", "encoder.s0")]
    run.traces = [Trace(bare)]
    assert snake.read(run) is None
    assert _metric_module("encoder_device_ms.dac").read(run) is None
    run.config = {"model": {}}
    assert argmin.read(run) is None and snake.read(run) is None


# -- the exchange's span -----------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank(rank, port, out):
    import torch.distributed as dist
    from esc_tpu_torch.parallel.mesh import DataParallel

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=2, rank=rank)
    try:
        dp = DataParallel(torch.device("cpu"))
        p = torch.nn.Parameter(torch.full((3,), float(rank)))
        p.grad = torch.full((3,), float(rank + 1))
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            dp.average_grads([p])
            mean = dp.mean(torch.tensor([float(rank)]))
        names = [e.name for e in prof.events() if e.name == "dp.allreduce"]
        with open(os.path.join(out, f"{rank}.json"), "w") as f:
            json.dump({"spans": len(names), "grad": p.grad.tolist(),
                       "mean": mean.tolist()}, f)
    finally:
        dist.destroy_process_group()


def test_data_parallel_exchange_runs_in_its_span(tmp_path):
    mp.spawn(_rank, args=(_free_port(), str(tmp_path)), nprocs=2)
    for rank in range(2):
        got = json.loads((tmp_path / f"{rank}.json").read_text())
        assert got == {"spans": 2, "grad": [1.5] * 3, "mean": [0.5]}
