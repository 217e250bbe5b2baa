"""Starved frames for the drone deployment's tests, on the CPU
(``test_torch_drone.py``) and on the card (``test_torch_cuda.py``): a flat
world with three small textured squares, too few corners for the 40
tracked points under which the stabilizer counts a frame as starved.
Imports neither JAX nor OpenCV, which the card's machine need not have.
"""

import numpy as np

SIDE = 48          # a textured square's side, full-frame px
PAD = 8            # the world's margin for the jitter
JITTER = 4
SPARSE, RICH = 3, 21   # squares in a starved frame, in a rich one


def _blur(img: np.ndarray, sigma: float) -> np.ndarray:
    """Separable gaussian blur (reflected edges) of a 2-D float32 image."""
    r = int(3 * sigma)
    k = np.exp(-0.5 * (np.arange(-r, r + 1) / sigma) ** 2)
    k = (k / k.sum()).astype(np.float32)
    for axis in (0, 1):
        p = np.pad(img, [(r, r) if a == axis else (0, 0) for a in (0, 1)],
                   mode="reflect")
        img = sum(np.take(p, np.arange(t, t + img.shape[axis]), axis=axis)
                  * k[t] for t in range(2 * r + 1))
    return img.astype(np.float32)


def starved_pool(n: int, h: int, w: int, rich=(), seed: int = 5
                 ) -> np.ndarray:
    """(n, 1, h, w, 3) u8 BGR frames of a flat world with three textured
    squares, one at the centre (where the LK prior correlates), seen
    through +-4 px of jitter. The frames in ``rich`` show eighteen more
    squares of the same world near its left and right edges, away from the
    region the prior searches, enough corners for the counter to reset;
    the three squares move with the jitter in every frame."""
    rng = np.random.default_rng(seed)
    worlds = [np.full((h + 2 * PAD, w + 2 * PAD), 100.0, np.float32)
              for _ in range(2)]
    for k in range(RICH):
        y = rng.integers(PAD + SIDE, h - SIDE)
        x = rng.integers(PAD + SIDE, w - SIDE)
        if k == 0:                   # the LK prior's patch sees this one
            y, x = PAD + (h - SIDE) // 2, PAD + (w - SIDE) // 2
        elif k >= SPARSE:            # outside the region the prior searches
            x = rng.integers(PAD, PAD + w // 5 - SIDE)
            x = x if k % 2 else w + 2 * PAD - SIDE - x
        tex = _blur(rng.random((SIDE, SIDE)).astype(np.float32), 2.0)
        for world in worlds if k < SPARSE else worlds[1:]:
            world[y:y + SIDE, x:x + SIDE] = (tex - tex.min()) / np.ptp(tex) \
                * 160.0 + 40.0
    out = np.empty((n, 1, h, w, 3), np.uint8)
    for i in range(n):
        dx, dy = rng.integers(-JITTER, JITTER + 1, 2)
        world = worlds[1 if i in rich else 0]
        f = world[PAD + dy:PAD + dy + h, PAD + dx:PAD + dx + w]
        out[i, 0] = np.clip(np.stack([f, np.roll(f, 1, 0), 255.0 - f], -1),
                            0, 255).astype(np.uint8)
    return out
