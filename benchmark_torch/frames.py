"""Camera frames made from the seed on the device.

The statistics of ``chip_smoke.py:make_frames`` (itself bench.py's pool),
rewritten in torch: a uniform random world blurred by a 13-tap gaussian
(sigma 2) with zero padding, stretched to [0, 255]; each frame a window of
it jittered by up to +-8 px in x and y, as BGR (world, world shifted down
a row, its negative) at 0.75, plus 60 above a horizon tilted by 2 deg so
that the roll estimate engages. Each stream has its own world and jitter.
"""

from __future__ import annotations

import math

import torch

PAD = 32
JITTER = 8
HORIZON_DEG = 2.0


def generator(seed: int, device, salt: int = 0) -> torch.Generator:
    """A generator on ``device`` seeded from ``seed`` (any integer up to
    2**63) and a salt that separates the benchmark's random streams."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + salt) % (2 ** 63))
    return g


def _blur(x: torch.Tensor, dim: int, kern: torch.Tensor) -> torch.Tensor:
    """'same' correlation with zero padding along ``dim``, as an explicit
    sum of shifted copies (no convolution algorithm to pick)."""
    r = kern.shape[0] // 2
    n = x.shape[dim]
    pad = [0, 0] * (x.dim() - 1 - dim % x.dim()) + [r, r]
    xp = torch.nn.functional.pad(x, pad)
    out = torch.zeros_like(x)
    for t in range(kern.shape[0]):
        out += xp.narrow(dim, t, n) * kern[t]
    return out


def make_pool(seed: int, n_frames: int, n_streams: int, height: int,
              width: int, device) -> torch.Tensor:
    """(n_frames, n_streams, height, width, 3) uint8 frames on ``device``."""
    g = generator(seed, device)
    world = torch.rand((n_streams, height + 2 * PAD, width + 2 * PAD),
                       generator=g, device=device)
    taps = torch.arange(-6, 7, dtype=torch.float32, device=device) / 2.0
    kern = torch.exp(-0.5 * taps * taps)
    kern = kern / kern.sum()
    world = _blur(_blur(world, 2, kern), 1, kern)
    lo = world.amin(dim=(1, 2), keepdim=True)
    hi = world.amax(dim=(1, 2), keepdim=True)
    world = ((world - lo) / torch.clamp(hi - lo, min=1e-6) * 255.0).to(
        torch.uint8).float()
    yy = torch.arange(height, dtype=torch.float32, device=device)[:, None]
    xx = torch.arange(width, dtype=torch.float32, device=device)[None, :]
    sky = (yy < height / 2.0 + math.tan(math.radians(HORIZON_DEG))
           * (xx - width / 2.0)).float()[:, :, None] * 60.0
    jit = torch.randint(-JITTER, JITTER + 1, (n_frames, n_streams, 2),
                        generator=g, device=device).cpu().tolist()
    pool = torch.empty((n_frames, n_streams, height, width, 3),
                       dtype=torch.uint8, device=device)
    for i in range(n_frames):
        for s in range(n_streams):
            dx, dy = jit[i][s]
            f = world[s, PAD + dy:PAD + dy + height, PAD + dx:PAD + dx + width]
            bgr = torch.stack([f, torch.roll(f, 1, 0), 255.0 - f], dim=-1)
            pool[i, s] = torch.clamp(bgr * 0.75 + sky, 0, 255).to(torch.uint8)
    return pool


def stream_seed(seed: int) -> int:
    """The stabilizer's ``seed`` for a run of ``seed``: stream s seeds its
    RANSAC generator with this + s."""
    return int(seed) % (2 ** 62)


def draw_table(seed: int, rows: int, n_streams: int, n_hypotheses: int,
               device) -> torch.Tensor:
    """(rows, n_streams, n_hypotheses, 2) uniforms in [0, 1): the draws of
    RANSAC's first ``rows`` analyze steps as the program makes them for a
    run of ``seed`` (``motion/estimate.py:ransac_draws``): stream s from a
    generator on ``device`` seeded with ``stream_seed(seed) + s``, one
    ``torch.rand((n_hypotheses, 2))`` a step."""
    out = torch.empty((rows, n_streams, n_hypotheses, 2), device=device)
    for s in range(n_streams):
        g = torch.Generator(device=device)
        g.manual_seed(stream_seed(seed) + s)
        for k in range(rows):
            out[k, s] = torch.rand((n_hypotheses, 2), generator=g,
                                   device=device)
    return out
