"""Kernel-contract auditor — the port's static-analysis plane (port of
``repro.analysis``, restated for PyTorch and the CUDA kernels).

The launch plane's invariants — every launch tallied, carried state
advanced in place, no plain version behind a failed launch, one accessor
per ``REPRO_*`` opt-in, one writer of the launch tally, launches inside the
card's per-block and per-SM limits, a calibration grid inside the fast
templates — are machine-checkable, so this package checks them.

Three passes, one CLI (``python -m repro_torch.launch.audit``):

  * ``contracts``  — Pass 1, AST kernel-contract linter (KC102, KC103,
    KC105–KC107): no import of the audited code, pure source analysis.
  * ``tracecheck`` — Pass 2, run-time hot-path auditor (TR201–TR205): runs
    the counting entry points on small inputs (dtypes, state in place,
    host synchronisations on the card, library loads).
  * ``vmem``       — Pass 3, static launch-budget checker (VM301–VM304):
    shared memory and registers of every instantiation, from the ``.cu``
    sources' constants, and the calibration grid against the fast
    templates' envelope.

Findings can be waived in place with a ``# audit-ok: <RULE> reason``
trailing comment (see ``findings``); waivers surface in the JSON report
rather than vanishing. The engines never import this package.
"""

from .findings import Finding, Report  # noqa: F401
