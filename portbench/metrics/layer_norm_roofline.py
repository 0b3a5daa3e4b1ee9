"""layer_norm_roofline: the least time the card needs for the LayerNorm calls
of the traced batches, over the device time of the kernels whose name holds
``layer_norm``, ``LayerNorm`` or ``RowwiseMoments``: the port's kernel
(``esc_tpu_torch/csrc/layer_norm.cu``) or ATen's (the row moments and the
normalisation at widths that are no multiple of 4, the vectorised kernel at
the others), so that it reads the same work whichever runs it.

The calls are counted here from the configuration at the traffic's batch,
length and streams: one ``(rows, C)`` per LayerNorm of one
``roundtrip(x, num_streams)``. A call reads its rows and the weight and
bias once and writes its rows once; about 8 operations an element (the
sum, the deviations and their squares, the scale and shift)."""

from portbench.readers import roofline_pct

KERNELS = ("layer_norm", "LayerNorm", "RowwiseMoments")


def layer_norm_calls(cfg: dict, batch: int, length: int, num_streams: int
                     ) -> list:
    """``(rows, C)`` of every LayerNorm call of one roundtrip of ESC's Swin
    codec: the patch embedding's, two in each Swin block, and one in each
    patch merge (width 2C, H halved and rounded up) or split."""
    hop = int(cfg["hop_len"] * cfg["sr"] * 1e-3)
    depth = cfg["swin_depth"]
    H = cfg["in_freq"] // cfg["patch_size"][0]
    W = (length // hop + 1) // cfg["patch_size"][1]
    h = cfg["h_dims"]
    calls = []

    def layer(Hl, C, scale=None):
        calls.extend([(batch * Hl * W, C)] * (2 * depth))
        if scale == "down":
            calls.append((batch * ((Hl + 1) // 2) * W, 2 * C))
        elif scale == "up":
            calls.append((batch * Hl * W, C))

    enc_H = [H]
    for _ in range(len(h) - 1):
        enc_H.append((enc_H[-1] + 1) // 2)
    calls.append((batch * H * W, h[0]))             # patch embedding
    layer(enc_H[0], h[0])                           # encoder pre_nn
    for i in range(len(h) - 1):                     # encoder blocks
        layer(enc_H[i], h[i], "down")
    dec_h, dec_H = h[::-1], enc_H[::-1]
    for i in range(num_streams - 2):                # decoder.encode's
        layer(dec_H[i], dec_h[i], "up")
    for i in range(len(h) - 1):                     # decoder.decode's blocks
        layer(dec_H[i], dec_h[i], "up")
    layer(dec_H[-1], dec_h[-1])                     # post_nn
    return calls


def calls(config, traffic):
    return [(4.0 * (2 * rows * C + 2 * C), 8.0 * rows * C)
            for rows, C in layer_norm_calls(config["model"], traffic["batch"],
                                            traffic["length"],
                                            traffic["num_streams"])]


def read(run):
    if "batch" not in run.traffic:
        return None
    return roofline_pct(run, KERNELS, calls)
