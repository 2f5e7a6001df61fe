"""setup_s: process start to the window's start: imports, the weights drawn
on the card, the engine and its pool, the kernels loaded (built, in a
checkout's first run), the traffic's own set-up (a document fill) and the
warm-up traffic."""


def read(r):
    return r.setup_s
