"""``barrier_wait_ms``: seconds the sessions' threads spent parked in the
cross-session batcher (``batch.barrier_wait`` spans) per window completed
inside the measured loop, in ms."""


def read(rec):
    waits = [s.dur for s in rec.spans if s.name == "batch.barrier_wait"]
    if not waits or not rec.done:
        return None
    return 1e3 * sum(waits) / len(rec.done)
