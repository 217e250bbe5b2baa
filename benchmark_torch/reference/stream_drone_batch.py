"""The plain reference of the drone high-frequency deployment served as N
lockstep feeds on one card (``MultiStreamStabilizer`` in drone mode): each
feed is the one-camera drone stream of ``stream_drone.py``, replayed on its
own.

A batched step holds each stream to the semantics of a single stream with
its own state: its frames, its starvation counter (and so its CLAHE
choice), its prior, its HF chain and its RANSAC draws, which stream s makes
from a generator seeded with ``frames.stream_seed(seed) + s``
(``frames.draw_table``). So stream s's frames are ``stream_drone.outputs``
on ``pool[:, s:s + 1]``, with the draws of a run whose stream seed is
``stream_seed(seed) + s``, and the S results are stacked on the stream
axis. Nothing of one stream reaches another here: a batch that mixes
streams' state or outputs differs from this.

The HF chain's thresholds (the dead zone's 3 and 4.5 px, its
accumulator's 3.6, micro-shake's ``hf_shake_px`` and twice it) are steps:
a transform that the program and this replay compute a few float32 ulps
apart (~1e-4 px at analysis scale: K6 against the plain ladder, summed
refits of ~500 px coordinates) and that lands within that distance of a
threshold takes one branch here and the other in the program, and the
stream's frames part by a pixel or more for the gaussian's 91 frames
after it. Each stream meets that as often as the one-camera cell's does;
a batch of N streams meets it N times as often a run.

``precision``: passed to each stream's replay (``stream_drone.py``). A
configuration names this file as its ``"reference":
"stream_drone_batch"``; ``check`` refuses what it does not model.
"""

from __future__ import annotations

import torch

from benchmark_torch import frames
from benchmark_torch.reference import stream_drone

SYSTEM = "multistream"
SEED_LIMIT = 2 ** 62          # frames.stream_seed's modulus


def one_stream(cfg: dict) -> dict:
    """The configuration of one of ``cfg``'s feeds as ``stream_drone.py``
    models it: the stabilizer alone, one stream."""
    return dict(cfg, system=stream_drone.FIXED["system"], streams=1,
                reference="stream_drone")


def check(cfg: dict) -> None:
    """Raise ValueError where ``cfg`` asks for what this reference does
    not model: another system than the batched step, no stream, or a feed
    that ``stream_drone.check`` refuses."""
    if cfg.get("system") != SYSTEM:
        raise ValueError(f"the drone batch reference models the system "
                         f"{SYSTEM!r} only, not {cfg.get('system')!r}")
    if not isinstance(cfg.get("streams"), int) or cfg["streams"] < 1:
        raise ValueError(f"the drone batch reference needs streams >= 1, "
                         f"not {cfg.get('streams')!r}")
    stream_drone.check(one_stream(cfg))


def outputs(cfg: dict, pool: torch.Tensor, n_calls: int, seed: int,
            sample_calls, precision: torch.dtype = torch.float32) -> dict:
    """The frames the program delivers at ``sample_calls``.

    pool: (P, S, H, W, 3) u8, call c consumes ``pool[c % P]``. n_calls:
    the calls made. seed: the run's. -> {call: (S, H, W, 3) u8}."""
    check(cfg)
    n_str = cfg["streams"]
    if pool.shape[1] != n_str:
        raise ValueError(f"pool holds {pool.shape[1]} streams, the "
                         f"configuration {n_str}")
    base = frames.stream_seed(seed)
    if base + n_str > SEED_LIMIT:
        raise ValueError(f"stream seeds {base} + s pass {SEED_LIMIT}: the "
                         f"one-stream replay cannot take them")
    one = one_stream(cfg)
    per = [stream_drone.outputs(one, pool[:, s:s + 1], n_calls, base + s,
                                sample_calls, precision=precision)
           for s in range(n_str)]
    return {c: torch.cat([p[c] for p in per]) for c in sorted(sample_calls)}
