"""Content masks for auto zoom-crop's ``interior_rect``, shared by the CPU
tests (``test_torch_azc.py``, ``test_torch_azc_kernel.py``) and the card's
(``test_torch_cuda.py``), which may not import JAX.

The rotated masks are the frame turned about its centre by a rotation
rounded to 1/4096ths, a pixel being content where its centre maps back
inside the frame: integer arithmetic alone, so every machine makes the
same masks (an image library's warp may round its edges differently from
one version to the next). ``RECTS[name][max_iters]`` is the JAX package's
rect for each mask after at most ``max_iters`` moves (None: the whole
loop), written down here so that the card's tests hold K7 to it without
JAX; ``test_torch_azc_kernel.py`` holds it to the JAX package on the CPU.

``mask_frame`` makes the BGR frames that K8 (the content mask) is held to
its plain version on, on the CPU through a replay of the kernel's tiles
and on the card: random colours, or values within 0.5 of a threshold (a
quarter of them on it), turned about the centre with black corners, at
the ``MASK_SHAPES`` (one pixel, a few, and sizes that cut K8's tiles
raggedly).
"""

import numpy as np

H, W = 72, 96
MAX_ITERS = (None, 0, 1, 31, 32, 33)


def rotated_content(deg: float, h: int = H, w: int = W) -> np.ndarray:
    """(h, w) float32 mask, 255 inside the frame rotated by ``deg`` about
    its centre, 0 outside."""
    c = int(round(np.cos(np.radians(deg)) * 4096))
    s = int(round(np.sin(np.radians(deg)) * 4096))
    yy, xx = np.mgrid[:h, :w].astype(np.int64)
    dx, dy = 2 * xx + 1 - w, 2 * yy + 1 - h     # centres, in half pixels
    sx, sy = c * dx + s * dy, c * dy - s * dx
    inside = (np.abs(sx) < 4096 * w) & (np.abs(sy) < 4096 * h)
    return np.where(inside, 255.0, 0.0).astype(np.float32)


MASK_SHAPES = ((1, 1), (2, 3), (5, 7), (33, 257), (70, 530))
MASK_KSIZES = (1, 3, 5, 7, 15)
MASK_THRESHOLDS = (0.0, 10.0, 200.0)


def mask_frame(h: int, w: int, seed: int, deg: float = 20.0,
               near=None) -> np.ndarray:
    """(h, w, 3) float32 BGR: uniform random u8 values, or with ``near``
    values in near +- 0.5 and a quarter of the pixels exactly near, black
    where the frame turned by ``deg`` leaves it (``rotated_content``)."""
    rng = np.random.default_rng(seed)
    if near is None:
        img = rng.integers(0, 256, (h, w, 3)).astype(np.float32)
    else:
        img = (near + rng.uniform(-0.5, 0.5, (h, w, 3))).astype(np.float32)
        img[rng.random((h, w)) < 0.25] = np.float32(near)
    return img * (rotated_content(deg, h, w) / 255.0)[..., None]


def _masks():
    full = np.full((H, W), 255.0, np.float32)
    out = {f"rot {d}": rotated_content(d) for d in (2.0, -7.0, 30.0, 60.0)}
    out["full"] = full
    out["empty"] = np.zeros((H, W), np.float32)
    tie = full.copy()
    tie[:3, :] = 0.0
    tie[-3:, :] = 0.0
    tie[:, :3] = 0.0
    tie[:, -3:] = 0.0
    out["tie"] = tie                         # equal holes on every edge
    dot = np.zeros((H, W), np.float32)
    dot[30, 40] = 255.0
    out["one pixel"] = dot
    return out


MASKS = _masks()

_FULL = (0, 0, W - 1, H - 1)
RECTS = {
    "rot 2.0": {None: (1, 2, 94, 69), 0: _FULL, 1: (0, 0, 95, 70),
                31: (1, 2, 94, 69), 32: (1, 2, 94, 69), 33: (1, 2, 94, 69)},
    "rot -7.0": {None: (3, 5, 92, 66), 0: _FULL, 1: (0, 0, 95, 70),
                 31: (3, 5, 92, 66), 32: (3, 5, 92, 66),
                 33: (3, 5, 92, 66)},
    "rot 30.0": {None: (1, 21, 94, 50), 0: _FULL, 1: (0, 0, 95, 70),
                 31: (0, 15, 95, 55), 32: (0, 16, 95, 55),
                 33: (0, 16, 95, 54)},
    "rot 60.0": {None: (27, 0, 68, 71), 0: _FULL, 1: (1, 0, 95, 71),
                 31: (16, 0, 80, 71), 32: (16, 0, 79, 71),
                 33: (17, 0, 79, 71)},
    "full": dict.fromkeys(MAX_ITERS, _FULL),
    "empty": dict.fromkeys(MAX_ITERS, (W, H, -1, -1)),
    "tie": dict.fromkeys(MAX_ITERS, (3, 3, 92, 68)),
    "one pixel": dict.fromkeys(MAX_ITERS, (40, 30, 40, 30)),
}
