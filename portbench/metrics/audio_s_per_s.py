"""audio_s_per_s: audio seconds encoded and decoded, host to host, over the
window's host-clock time from its start to the end of its last batch."""


def read(run):
    audio = sum(u.get("audio_s", 0.0) for u in run.units)
    return audio / run.window_s if audio and run.window_s else None
