"""Stabilized frames delivered to the host in the window, every stream's,
over the window's length."""


def read(window):
    if window.elapsed_s <= 0.0:
        return None
    return window.frames / window.elapsed_s
