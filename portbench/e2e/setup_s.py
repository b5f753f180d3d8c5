"""Seconds from process start to the first timed call: imports, the CUDA
context, the kernel libraries (built on a checkout's first run), the
recordings, the warm-up calls."""


def read(w):
    return w.setup_s
