"""K2 (``csrc/warp.cu``, ``warp_tile_kernel`` in its projective mode): the
homography emit warp. Per output pixel K1's maps plus a third row and two
divides (15 operations) and the 9-operation blend per channel."""

SYMBOL = "warp_tile_kernel"


def launches(cfg: dict) -> list:
    """(bytes, operations) of each K2 launch of one call: the emit of the
    homography model, one launch for every stream."""
    if cfg["stabilizer"].get("motion_model", "similarity") != "homography":
        return []
    h, w, s = cfg["height"], cfg["width"], cfg["streams"]
    return [(s * 2 * h * w * 3, s * h * w * (15 + 9 * 3))]
