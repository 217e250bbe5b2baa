"""The 95th percentile, in ms, of every call's latency in an open-loop
window: from the call's due time on the camera's schedule to the return
of the call with the delivered frame on the host."""

import numpy as np


def read(window):
    if not window.latencies_s:
        return None
    return float(np.percentile(window.latencies_s, 95)) * 1e3
