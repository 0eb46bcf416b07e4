"""``level_self_ms``: the level loop's own host time per window completed
inside the measured loop, in ms: the self time of ``stream.prepare`` and
``stream.commit`` spans, less the spans inside them (``stream.launch``,
``stream.recount``, ``stream.checkpoint``, kernel dispatch)."""

from chipbench.trace import self_seconds


def read(rec):
    if not rec.done:
        return None
    own = self_seconds(rec.spans, {"stream.prepare", "stream.commit"})
    return 1e3 * own / len(rec.done)
