"""train_steps_per_s: the steps completed in the window, whole, over the
host-clock time from the window's start to the end of the last of them."""


def read(run):
    steps = [u for u in run.units if "step" in u]
    return len(steps) / run.window_s if steps and run.window_s else None
