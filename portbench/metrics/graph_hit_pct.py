"""graph_hit_pct: the share of the program's codec calls served by
replaying captured stage graphs: 100 x the spans ``codec.replay`` over the
spans ``codec.encode`` and ``codec.decode``
(``esc_tpu_torch/utils/graphs.py``), in the traced units. None where the
trace holds no ``codec.replay`` (a program without stage graphs) or no
device operation."""


def read(run):
    t = run.traces[0] if run.traces else None
    if t is None or not t.device or not run.traced_units:
        return None
    names = [name for name, _, _ in t.spans]
    replays = names.count("codec.replay")
    calls = names.count("codec.encode") + names.count("codec.decode")
    return 100.0 * replays / calls if replays and calls else None
