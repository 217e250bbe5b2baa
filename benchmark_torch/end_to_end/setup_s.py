"""Seconds from the process's start to the window's first call: imports,
the kernels' build (or load), the frames and draws made from the seed,
the program's state and the warm-up calls."""


def read(window):
    return window.setup_s
