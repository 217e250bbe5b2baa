"""K1 (``csrc/warp.cu``, ``warp_tile_kernel`` in its affine mode): the
two-pass roll's whole-frame rotation with the similarity model.

With the similarity model the chain rotates the whole enhanced frame
(3 channels, replicated border) in a pass of its own before the
stabilizer (``core/chain.py:_pre_stages``) where it cannot compose the
roll into the emit: with auto zoom-crop on, or a roll band wider than
15 deg (``ChainParams.roll_fusion_active``). Per output pixel K1's 10
map operations and a 9-operation blend per channel; each input byte read
once, each output byte written once."""

SYMBOL = "warp_tile_kernel"
FUSED_BAND_DEG = 15.0


def launches(cfg: dict) -> list:
    """(bytes, operations) of the rotation's one launch a call, for a
    similarity chain whose roll runs in two passes; none otherwise."""
    ro, st = cfg.get("roll"), cfg["stabilizer"]
    if ro is None or st.get("motion_model", "similarity") != "similarity":
        return []
    band = max(abs(ro["angle_filter_min"]), abs(ro["angle_filter_max"]))
    if not (cfg.get("azc") or {}).get("enabled") and band <= FUSED_BAND_DEG:
        return []
    h, w = cfg["height"], cfg["width"]
    return [(2 * h * w * 3, h * w * (10 + 9 * 3))]
