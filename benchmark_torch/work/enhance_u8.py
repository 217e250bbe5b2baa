"""K4 (``csrc/enhance.cu``, ``enhance_table_kernel``): the enhancer's
pointwise stages, u8 in and out, with the float32 gray the roll estimate
reads. Per value contrast, brightness and gamma, 8 operations; per pixel
the gray, 5 (``chip_smoke.py``'s counts)."""

SYMBOL = "enhance_table_kernel"


def launches(cfg: dict) -> list:
    """(bytes, operations) of the one K4 launch of a chain call."""
    if cfg.get("enhancer") is None:
        return []
    n = cfg["height"] * cfg["width"]
    if cfg.get("roll") is not None:
        return [(n * (3 + 3 + 4), n * (3 * 8 + 5))]
    return [(n * (3 + 3), n * 3 * 8)]
