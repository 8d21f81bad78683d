"""setup_s: process start to the first timed call: imports, the card's
start, the kernels' build where it is not cached, the inputs, the
program's state and the warm-up."""


def read(r):
    return r.setup_s
