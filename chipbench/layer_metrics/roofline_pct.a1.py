"""``roofline_pct.a1``: the exact (A1) counting kernels' share of their
roofline: the least time the card could take for the A1 counts that the
completed windows need (each level's A2 survivors over the window's
events, ``work.least_seconds``), over the device time of the A1 family's
kernels (``trace.families``) inside the measured loop."""

from chipbench.trace import family_seconds
from chipbench.work import least_seconds


def read(rec):
    dev = family_seconds(rec, "a1")
    if dev <= 0:
        return None
    lcap = rec.config["lcap"]
    least = sum(least_seconds(n, hist, surv, lcap, relaxed=False)
                for n, hist, levels in rec.work.values()
                for _, _, surv in levels)
    return 100.0 * least / dev
