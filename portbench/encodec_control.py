"""The control of the EnCodec cell's comparison: what it reads when the
program errs.

    python3 portbench/encodec_control.py \
        --workload encodec-24khz-24kbps.serve-batch --seeds 11 12 13 \
        [--stand-in float64]

puts the plain reference (``portbench/reference/encodec.py``) in the
program's place, at the cell's own sizes, and judges what it serves as a
run judges the program, against the same reference in float32
(``portbench/drivers/common.py::check_serving``), as
``portbench/dac_control.py`` does for the DAC's cell. The stand-in
computes in TF32 (products, the LSTM's included, and cuDNN convolutions),
the nearest precision below the float32-with-TF32-off that the
configuration states, which a run must fail; or, with ``--stand-in
float64``, in float64: a sound computation that rounds otherwise than the
reference, which a run must pass. For each seed it prints one JSON line
of the numbers compared; the benchmark's runs never run this. Needs a
CUDA device, like the benchmark.
"""

import argparse
import json
import math
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import torch  # noqa: E402

from portbench.control import tf32  # noqa: E402
from portbench.harness import Run, load_json  # noqa: E402
from portbench.reference import encodec as ref_encodec  # noqa: E402
from portbench.reference.weights import seeded_generator  # noqa: E402
from portbench.signals import speech_like  # noqa: E402

BENCH = REPO / "portbench"


def serving(run: Run, stand_in_dtype: str) -> None:
    """The stand-in (``tf32`` or ``float64``) serves ``check`` batches made
    from the seed at the traffic's bandwidth; the float32 reference judges
    its codes and waveforms."""
    from portbench.drivers.common import check_serving

    tr, dev, cfg = run.traffic, run.device, run.config
    gen = seeded_generator(run.seed, dev)
    with torch.device(dev):
        ref = ref_encodec.Encodec(**cfg["Encodec"], **cfg["SEANet"])
        stand_in = ref_encodec.Encodec(**cfg["Encodec"], **cfg["SEANet"])
    ref_encodec.init_weights(ref, gen)
    stand_in.load_state_dict(ref.state_dict())
    codec = cfg["Encodec"]            # bits a second per codebook
    per_cb = (codec["sample_rate"] / math.prod(codec["ratios"])
              * math.log2(codec["bins"]))
    n_q = max(1, math.floor(tr["bandwidth"] * 1000 / per_cb))
    wide = stand_in_dtype == "float64"
    if wide:
        stand_in.double()
    samples = []
    for _ in range(tr["check"]):
        x = speech_like(gen, tr["batch"], tr["length"], dev)
        tf32(not wide)
        codes = stand_in.encode(x.double() if wide else x, n_q)
        wave = stand_in.decode(codes).float()
        tf32(False)
        samples.append((x.cpu().numpy(), codes.cpu().numpy(),
                        wave.cpu().numpy()))
    del stand_in
    torch.cuda.empty_cache()
    check_serving(run, ref.cpu(), samples)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--stand-in", choices=("tf32", "float64"),
                   default="tf32")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("encodec_control: needs a CUDA device", file=sys.stderr)
        return 2
    bench = load_json(REPO / "BENCHMARK.json")
    cell = next(c for c in bench["workloads"] if c["name"] == args.workload)
    config = load_json(BENCH / "configs" / f"{cell['config']}.json")
    traffic = load_json(BENCH / "traffic" / f"{cell['traffic']}.json")
    for seed in args.seeds:
        run = Run(workload=args.workload, config=config, traffic=traffic,
                  seed=seed, seconds=0, trace=False, device="cuda",
                  t_start=0.0)
        serving(run, args.stand_in)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": args.stand_in, "correct": run.correct,
                          "checks": run.checks, "notes": run.notes}),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
