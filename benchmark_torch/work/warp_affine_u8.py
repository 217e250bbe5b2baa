"""K1 (``csrc/warp.cu``, ``warp_tile_kernel`` in its affine mode): the
affine u8 warp.

Per output pixel the two rounded 3-term coordinate maps and the fractions
(10 operations) and a 9-operation blend per channel; each input byte read
once, each output byte written once (``chip_smoke.py``'s counts)."""

SYMBOL = "warp_tile_kernel"


def flops(channels: int) -> int:
    return 10 + 9 * channels


def launches(cfg: dict) -> list:
    """(bytes, operations) of each K1 launch of one call. The similarity
    model's emit, one launch for every stream; with roll correction the
    rotation: of the analysis gray where the similarity chain composes the
    roll into the emit, of the whole enhanced frame (3 channels) where the
    homography chain rotates it in a pass of its own
    (``core/chain.py:_pre_stages``) before K2's emit."""
    st = cfg["stabilizer"]
    model = st.get("motion_model", "similarity")
    h, w, s = cfg["height"], cfg["width"], cfg["streams"]
    out = []
    if model == "similarity":
        out.append((s * 2 * h * w * 3, s * h * w * flops(3)))
    if cfg.get("roll") is not None:
        if model == "similarity":
            ha, wa = st["analysis_height"], st["analysis_width"]
            out.append((2 * ha * wa, ha * wa * flops(1)))
        elif model == "homography":
            out.append((2 * h * w * 3, h * w * flops(3)))
    return out
