"""K6 (``csrc/lk.cu``, ``lk_track_kernel``): the pyramidal LK ladder, one
launch for every stream's points.

Bytes: per point and level the template's (win + 1)^2 footprint in the
three prev planes and one in the current plane, float32; the points, the
mask and the outputs (``chip_smoke.py``'s count). Operations: the
templates' 33 a window pixel per point and level. The Newton steps, 14 a
window pixel each, are left out: how many a point runs depends on the
frames, so the count is a lower bound of the work; the bytes bound it."""

SYMBOL = "lk_track_kernel"
TEMPLATE_OPS = 33


def launches(cfg: dict) -> list:
    """(bytes, operations) of an analyze step's one K6 launch."""
    st = cfg["stabilizer"]
    n = cfg["streams"] * st["max_corners"]
    levels = st["lk_levels"] + 1
    win = st["lk_window"]
    nbytes = n * (levels * 4 * (win + 1) ** 2 * 4 + 8 + 1 + 8 + 1 + 4)
    return [(nbytes, win * win * n * levels * TEMPLATE_OPS)]
