"""The comparison that decides ``correct``: every window whose delta came
back, against the plain reference (``reference/miner.py``) run over the
same windows of the same recording.

A window matches when every level matches: its number of candidates, of
A2 survivors, and its frequent episodes (types and gaps) with their
per-window counts. The comparison is exact; its limit is 0 windows.
"""

from __future__ import annotations

from chipbench.reference.miner import Session


def canonical(result) -> list:
    """A ``MiningResult`` as the reference reports a window."""
    out = []
    for stats, batch, counts in zip(result.stats, result.frequent,
                                    result.counts):
        freq = {(tuple(et), tuple(lo), tuple(hi)): int(c)
                for et, lo, hi, c in zip(batch.etypes.tolist(),
                                         batch.tlo.tolist(),
                                         batch.thi.tolist(), counts.tolist())}
        out.append((stats.level, stats.num_candidates,
                    stats.num_survived_a2, freq))
    return out


def compare(config: dict, recordings, answers, device):
    """Hold ``answers`` ({array: {window: canonical result}}) against the
    reference. Returns (windows compared, windows that differ, the
    reference's per-window work {(array, window): [(level, candidates,
    survivors)]})."""
    compared = differ = 0
    work = {}
    for i, got in answers.items():
        if not got:
            continue
        types, times, bounds = recordings[i]
        ref = Session(config, types, times, bounds, device)
        for p in range(max(got) + 1):
            want = ref.step()
            work[(i, p)] = ref.work[-1]
            if p in got:
                compared += 1
                differ += got[p] != want
    return compared, differ, work


def reference_answers(config: dict, recordings, windows: dict, device,
                      carry: bool):
    """The reference's own answers for ``windows`` ({array: last window}),
    to put in the program's place: with ``carry=False`` (see ``Session``)
    they are the control's."""
    out = {}
    for i, last in windows.items():
        types, times, bounds = recordings[i]
        ref = Session(config, types, times, bounds, device, carry=carry)
        out[i] = {p: ref.step() for p in range(last + 1)}
    return out
