"""The 95th percentile (nearest rank) of the wall time of every call in
the window, each timed from its start until its result is returned."""

import math


def read(rec):
    durs = sorted(c["t1"] - c["t0"] for c in rec.calls)
    if not durs:
        return None
    return 1e3 * durs[max(0, math.ceil(0.95 * len(durs)) - 1)]
