"""lstm_roofline: the least time the card needs for EnCodec's LSTM layers
of the traced batches, over the device time in which whatever was launched
inside the program's ``encoder.lstm`` and ``decoder.lstm`` spans runs
(cuDNN's recurrence today, a kernel written for it later), so that it
reads the same work whichever computes it. That time merges the
operations' intervals (:func:`portbench.busy.busy_ms`): cuDNN runs some of
its kernels side by side, and their summed durations would count the
overlap as time the LSTM holds the card.

The work is counted here from the configuration and the traffic: on each
side (encoder and decoder) ``lstm`` layer-runs of hidden size ``H`` over
``N = B T`` tokens (``T`` the frames of a clip, its length over the hop),
each token ``2 4H (I + H)`` operations for its two products (``I = H``);
each run reads its weights and biases once, ``4H (I + H) + 2 4H`` values,
and its input and output once, ``N (I + H)``: ``4`` bytes each. The least
time is the larger of operations over 67 TFLOP/s and bytes over 3.35 TB/s
(operations at the cell's shapes: 60.4 GFLOP a batch, 0.901 ms)."""

from portbench.reference.work import bound_s
from portbench.busy import busy_ms


def layer_runs(config: dict, traffic: dict) -> list:
    """``(N, I, H)`` of every LSTM layer-run of one ``encode_codes`` +
    ``decode_codes`` of the batch."""
    cfg, seanet = config["Encodec"], config["SEANet"]
    hop = 1
    for r in cfg["ratios"]:
        hop *= r
    H = cfg["n_filters"] * 2 ** len(cfg["ratios"])
    N = traffic["batch"] * -(-traffic["length"] // hop)
    return [(N, H, H)] * (2 * seanet["lstm"])


def calls(config, traffic):
    return [(4.0 * (4 * H * (I + H) + 2 * 4 * H + N * (I + H)),
             2.0 * 4 * H * (I + H) * N)
            for N, I, H in layer_runs(config, traffic)]


def read(run):
    if "Encodec" not in run.config or not run.traced_units:
        return None
    ms = busy_ms(run, "encoder.lstm", "decoder.lstm")
    if not ms:
        return None
    least = sum(bound_s(nbytes, flops)[0]
                for nbytes, flops in calls(run.config, run.traffic))
    return 100.0 * least / (ms * 1e-3)
