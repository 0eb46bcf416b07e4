"""``roofline_pct.a2``: the relaxed (A2) counting kernels' share of their
roofline: the least time the card could take for the A2 counts that the
completed windows need (each level's candidates over the window's events,
``work.least_seconds``), over the device time of the A2 family's kernels
(``trace.families``) inside the measured loop."""

from chipbench.trace import family_seconds
from chipbench.work import least_seconds


def read(rec):
    dev = family_seconds(rec, "a2")
    if dev <= 0:
        return None
    least = sum(least_seconds(n, hist, cand, 1, relaxed=True)
                for n, hist, levels in rec.work.values()
                for _, cand, _ in levels)
    return 100.0 * least / dev
