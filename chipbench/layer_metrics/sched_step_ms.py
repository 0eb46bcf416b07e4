"""``sched_step_ms``: the mean length of the service scheduler's
``schedule.step`` spans inside the measured loop (one step services one
window of every chosen session)."""


def read(rec):
    steps = [s.dur for s in rec.spans if s.name == "schedule.step"]
    return 1e3 * sum(steps) / len(steps) if steps else None
