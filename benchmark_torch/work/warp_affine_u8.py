"""K1 (``csrc/warp.cu``, ``warp_tile_kernel``): the affine u8 warp.

Per output pixel the two rounded 3-term coordinate maps and the fractions
(10 operations) and a 9-operation blend per channel; each input byte read
once, each output byte written once (``chip_smoke.py``'s counts)."""

SYMBOL = "warp_tile_kernel"


def flops(channels: int) -> int:
    return 10 + 9 * channels


def launches(cfg: dict) -> list:
    """(bytes, operations) of each K1 launch of one call: the emit, one
    launch for every stream, and in the fused chain the rotation of the
    analysis gray."""
    st = cfg["stabilizer"]
    if st.get("motion_model", "similarity") != "similarity":
        return []
    h, w, s = cfg["height"], cfg["width"], cfg["streams"]
    out = [(s * 2 * h * w * 3, s * h * w * flops(3))]
    if cfg.get("roll") is not None:
        ha, wa = st["analysis_height"], st["analysis_width"]
        out.append((2 * ha * wa, ha * wa * flops(1)))
    return out
