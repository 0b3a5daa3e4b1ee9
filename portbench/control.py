"""The control of a cell's comparison: what it reads when the program errs.

    python3 portbench/control.py --workload esc-base.serve-batch \
        --seeds 11 12 13 [--fault half_batch]

puts the plain reference in the program's place, at the cell's own sizes,
and judges it as a run judges the program, against the same reference in
float32. Without ``--fault`` the stand-in computes in TF32 (products and
cuDNN convolutions), the nearest precision below the float32-with-TF32-off
that the configurations state: the step that would tempt a later change.
With ``--fault half_batch`` it computes in float32 but breaks one guarantee
a training cell has: each step takes the first half of its rows and the
mean over them. A training cell's stand-in takes the first steps, then
:data:`WINDOW_STEPS` steps as a window would, then the window's next step,
which is judged from its own state.
(A step that leaves its state unchanged reads 1 on ``step_gap`` and
``window_step_gap`` by their definition and needs no run.) For each seed
it prints one JSON line of the numbers compared; the benchmark's runs
never run this.
Needs a CUDA device, like the benchmark.
"""

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench.harness import Run, load_json  # noqa: E402
from portbench.reference import disc as ref_disc_mod  # noqa: E402
from portbench.reference import esc as ref_esc  # noqa: E402
from portbench.reference.train import RefTrainer  # noqa: E402
from portbench.reference.weights import fill, seeded_generator  # noqa: E402
from portbench.signals import dropout_streams, speech_like  # noqa: E402

BENCH = REPO / "portbench"
# the steps a training cell's stand-in takes for a window: what 20 s of the
# adversarial cell hold; what the step after it reads does not hang on
# the window's length (PERF.md)
WINDOW_STEPS = 29


def tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def serving(run: Run, fault) -> None:
    """The TF32 stand-in serves the inputs a run checks (``check`` batches
    or ``check_per_length`` requests of each length, streams drawn from
    the seed); the float32 reference judges its codes and waveforms."""
    from portbench.drivers.common import check_serving

    if fault:
        raise SystemExit("a serving cell's control takes no --fault")
    tr, dev, cfg = run.traffic, run.device, run.config["model"]
    gen = seeded_generator(run.seed, dev)
    with torch.device(dev):
        ref = ref_esc.ESC(**cfg)
    fill(ref, gen)
    with torch.device(dev):
        stand_in = ref_esc.ESC(**cfg)
    stand_in.load_state_dict(ref.state_dict())
    rng = np.random.default_rng(run.seed)
    if "batch" in tr:
        inputs = [(speech_like(gen, tr["batch"], tr["length"], dev),
                   tr["num_streams"]) for _ in range(tr["check"])]
    else:
        inputs = [(speech_like(gen, 1, n, dev),
                   int(rng.choice(tr["streams"])))
                  for n in tr["lengths"]
                  for _ in range(tr["check_per_length"])]
    samples = []
    tf32(True)
    for x, ns in inputs:
        codes, shape = stand_in.encode(x, ns)
        wave = stand_in.decode(codes, shape)
        samples.append((x.cpu().numpy(), codes.cpu().numpy(),
                        wave.cpu().numpy()))
    tf32(False)
    check_serving(run, ref.cpu(), samples)


def training(run: Run, fault) -> None:
    """The stand-in takes the cell's first steps, :data:`WINDOW_STEPS`
    more and the window's next one (TF32, or float32 with the fault); the
    float32 reference judges them as :func:`portbench.drivers.train.judge`
    and :func:`~portbench.drivers.train.judge_window` judge the
    program's."""
    from portbench.drivers.train import (CHECKED_STEPS, _named,
                                         _program_names, _weights, judge,
                                         judge_window)

    tr, dev, cfg = run.traffic, run.device, run.config
    adv = "discriminator" in cfg
    gen = seeded_generator(run.seed, dev)
    with torch.device(dev):
        ref_gen = ref_esc.ESC(**cfg["model"])
        ref_d = ref_disc_mod.Discriminator(**cfg["discriminator"]) \
            if adv else None
    fill(ref_gen, gen)
    if adv:
        fill(ref_d, gen)
    batches = [speech_like(gen, tr["batch"], tr["length"], dev).cpu()
               for _ in range(tr["pool"])]
    streams = dropout_streams(tr["dropout_rate"],
                              cfg["model"]["max_streams"], 20000, run.seed)
    with torch.device(dev):
        s_gen = ref_esc.ESC(**cfg["model"])
        s_d = ref_disc_mod.Discriminator(**cfg["discriminator"]) \
            if adv else None
    s_gen.load_state_dict(ref_gen.state_dict())
    if adv:
        s_d.load_state_dict(ref_d.state_dict())
    ref_gen.cpu()
    if adv:
        ref_d.cpu()
    stand_in = RefTrainer(s_gen, s_d, _weights(cfg), tr["lr"])

    def params():
        return {n: p.detach().to("cpu", copy=True)
                for n, p in _named(s_gen, s_d).items()}

    def take(k, keep=False):
        x = batches[k % len(batches)].to(dev)
        if fault == "half_batch":
            x = x[:len(x) // 2]
        return stand_in.step(x, streams[k], keep=keep)

    tf32(fault is None)
    losses, first = [], None
    for k in range(CHECKED_STEPS):
        losses.append(take(k, keep=k == 0))
        if k == 0:
            first = _program_names(stand_in.kept_grads)
    after = params()
    step = CHECKED_STEPS + WINDOW_STEPS
    for k in range(CHECKED_STEPS, step):
        take(k)
    named = _named(s_gen, s_d)
    before = {"params": params(), "mu": {}, "nu": {}, "count": {}}
    for prefix, opt in (("", stand_in.opt), ("disc.", stand_in.opt_disc)):
        if opt is None:
            continue
        ids = {id(p) for g in opt.param_groups for p in g["params"]}
        for n, p in named.items():
            if id(p) in ids:
                before["mu"][n] = opt.state[p]["exp_avg"].cpu()
                before["nu"][n] = opt.state[p]["exp_avg_sq"].cpu()
                before["count"][prefix] = int(opt.state[p]["step"])
    last = {"step": step, "before": before, "losses": take(step, keep=True)}
    last["grads"] = _program_names(stand_in.kept_grads)
    last["after"] = params()
    tf32(False)
    del stand_in, s_gen, s_d, named
    torch.cuda.empty_cache()
    judge(run, ref_gen, ref_d, batches, streams, losses, first, after, dev)
    judge_window(run, ref_gen, ref_d, batches[step % len(batches)],
                 streams[step], last, dev)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--fault", choices=("half_batch",))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    bench = load_json(REPO / "BENCHMARK.json")
    cell = next(c for c in bench["workloads"] if c["name"] == args.workload)
    config = load_json(BENCH / "configs" / f"{cell['config']}.json")
    traffic = load_json(BENCH / "traffic" / f"{cell['traffic']}.json")
    for seed in args.seeds:
        run = Run(workload=args.workload, config=config, traffic=traffic,
                  seed=seed, seconds=0, trace=False, device="cuda",
                  t_start=0.0)
        if traffic["driver"] == "train":
            training(run, args.fault)
        else:
            serving(run, args.fault)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": args.fault or "tf32",
                          "correct": run.correct, "checks": run.checks,
                          "notes": run.notes}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
