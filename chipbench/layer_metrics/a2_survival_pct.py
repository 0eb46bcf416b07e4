"""``a2_survival_pct``: the share of candidates at levels 2 and up that
the two-pass cull's A2 bound lets through to exact counting, over the
windows completed inside the measured loop (the program's ``LevelStats``,
a count that repeats exactly for a seed)."""


def read(rec):
    cand = surv = 0
    for key in rec.stats:
        for s in rec.stats[key]:
            if s.level >= 2:
                cand += s.num_candidates
                surv += s.num_survived_a2
    return 100.0 * surv / cand if cand else None
