"""K3 (``csrc/features.cu``, ``corner_strip_kernel``): the Shi-Tomasi
response and its 3x3 peak mask of the analysis gray. Per pixel 4 bytes
in, 4 + 1 out; two Sobel stencils, three products, their 3x3 sums and the
eigenvalue, 55 operations (``chip_smoke.py``'s counts)."""

SYMBOL = "corner_strip_kernel"
OPS_PER_PIXEL = 55


def launches(cfg: dict) -> list:
    """(bytes, operations) of a detection's one launch for every stream."""
    st = cfg["stabilizer"]
    if st.get("feature_detector", "gftt") != "gftt":
        return []
    n = cfg["streams"] * st["analysis_height"] * st["analysis_width"]
    return [(n * (4 + 4 + 1), n * OPS_PER_PIXEL)]
