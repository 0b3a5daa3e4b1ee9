"""snake_roofline: the least time the card needs for the DAC's snake
activations of the traced batches, over the device time of whatever ran
inside the program's ``act.snake`` spans (``esc_tpu_torch/baselines/dac/
layers.py::Snake1d``): ATen's elementwise kernels or a kernel written for
it, so that it reads the same work whichever computes it.

The calls are counted here from the configuration and the traffic: one
``(C, T)`` per snake of one ``encode_codes`` + ``decode_codes`` of the
batch, each reading its ``B C T`` elements and ``C`` alphas once and
writing ``B C T`` once, in one pass: ``4 (2 B C T + C)`` bytes over 3.35
TB/s (about 5 operations an element: a product, a sine, a square, a
quotient and a sum; a bound by bytes)."""

from portbench.reference.work import bound_s
from portbench.spans import device_ms


def _conv(T: int, k: int, s: int, p: int) -> int:
    return (T + 2 * p - k) // s + 1


def snake_calls(cfg: dict, length: int) -> list:
    """``(C, T)`` of every snake call of one padded roundtrip of a clip of
    ``length`` samples: in each residual unit two, in each encoder block
    one before its strided conv, in each decoder block one before its
    transposed conv, and one before each of the last two convs."""
    calls = []
    C, T = cfg["encoder_dim"], length
    for s in cfg["encoder_rates"]:               # encoder blocks
        calls += [(C, T)] * 7
        T = _conv(T, 2 * s, s, -(-s // 2))
        C *= 2
    calls.append((C, T))                         # encoder.post
    C = cfg["decoder_dim"]
    for s in cfg["decoder_rates"]:               # decoder blocks
        calls.append((C, T))
        T = (T - 1) * s - 2 * -(-s // 2) + 2 * s
        C //= 2
        calls += [(C, T)] * 6
    calls.append((C, T))                         # decoder.post
    return calls


def calls(config, traffic):
    B = traffic["batch"]
    return [(4.0 * (2 * B * C * T + C), 5.0 * B * C * T)
            for C, T in snake_calls(config["DAC"], traffic["length"])]


def read(run):
    if "DAC" not in run.config or not run.traced_units:
        return None
    ms = device_ms(run, "act.snake")
    if not ms:
        return None
    least = sum(bound_s(nbytes, flops)[0]
                for nbytes, flops in calls(run.config, run.traffic))
    return 100.0 * least / (ms * 1e-3)
