"""setup_s: process start to the first timed call (imports, the kernel
library, weights from the seed, warm-up of the cell's shapes), host clock."""


def read(run):
    return run.setup_s
