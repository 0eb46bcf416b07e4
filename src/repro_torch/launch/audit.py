"""CLI for the kernel-contract auditor (``repro_torch.analysis``).

Usage::

    python -m repro_torch.launch.audit [--fail-on-violation] \
        [--root src/repro_torch] [--summary PATH] [--json] \
        [--skip-trace] [--skip-sentinel] [--budget-mib X]

Pass 1 (contract linter) and Pass 3 (launch budget) always run; they are
pure source and arithmetic and take milliseconds. Pass 2 (run-time audit
and library sentinel) imports torch and the engines and runs them on
small inputs, on the CPU and, where there is one, on the card — skip it
with ``--skip-trace`` for a fast editor hook, or keep the entry-point and
synchronisation audits but drop the (slower) streaming sentinel with
``--skip-sentinel``. ``--budget-mib`` sets the shared-memory budget of a
block (default the H100's 227 KB).

Exit status: 0 when no active findings (suppressed waivers don't fail
the audit; they are listed in the report), 1 otherwise with
``--fail-on-violation``, 2 when the source root is missing. Without the
flag the exit status is 0, so local runs can be wired into non-blocking
tooling.
"""

from __future__ import annotations

import argparse
import pathlib
import sys


def _sources(root: pathlib.Path, findings) -> dict[str, list[str]]:
    """The source lines of the files ``findings`` point at (paths relative
    to ``root``'s parent), for their ``# audit-ok`` markers."""
    out = {}
    for f in findings:
        path = root.parent / f.path
        if f.path not in out and path.is_file():
            out[f.path] = path.read_text().splitlines()
    return out


def build_report(root: pathlib.Path, trace: bool, sentinel: bool,
                 budget_bytes: int | None = None):
    from repro_torch.analysis import vmem
    from repro_torch.analysis.contracts import lint_tree
    from repro_torch.analysis.findings import Report, split_suppressed

    report = Report()
    active, waived, summary = lint_tree(root)
    report.extend(active, waived, **summary)

    budget = budget_bytes or vmem.SMEM_BLOCK_BYTES
    vf, vs = vmem.check_smem(budget=budget)
    report.extend(vf, **vs)
    # the dispatch-calibration grid must stay inside the fast templates,
    # or the fitted policy measures the generic instantiations
    from repro_torch.core.calibrate import GridSpec
    cf, cs = vmem.check_calibration_grid(GridSpec().points())
    report.extend(cf, **cs)

    if trace:
        from repro_torch.analysis import tracecheck
        tf, ts = tracecheck.run(sentinel=sentinel)
        active, waived = split_suppressed(tf, _sources(root, tf))
        report.extend(active, waived, **ts)

    from repro_torch.kernels.tally import launch_counts
    report.summary["kernel_calls"] = launch_counts()
    return report


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.audit",
        description="kernel-contract auditor (see repro_torch.analysis)")
    p.add_argument("--root", default="src/repro_torch",
                   help="source root for the contract linter")
    p.add_argument("--fail-on-violation", action="store_true",
                   help="exit 1 when any active finding remains")
    p.add_argument("--summary", default=None, metavar="PATH",
                   help="also write the JSON report to PATH")
    p.add_argument("--json", action="store_true",
                   help="print the JSON report instead of the human one")
    p.add_argument("--skip-trace", action="store_true",
                   help="skip Pass 2 entirely (nothing is run)")
    p.add_argument("--skip-sentinel", action="store_true",
                   help="run Pass 2 without the streaming library "
                        "sentinel")
    p.add_argument("--budget-mib", type=float, default=None,
                   help="override the shared-memory budget of a block "
                        "(MiB)")
    args = p.parse_args(argv)

    root = pathlib.Path(args.root)
    if not root.is_dir():
        print(f"audit: source root {root} not found", file=sys.stderr)
        return 2
    budget = int(args.budget_mib * 2**20) if args.budget_mib else None
    report = build_report(root, trace=not args.skip_trace,
                          sentinel=not args.skip_sentinel,
                          budget_bytes=budget)

    print(report.to_json() if args.json else report.format())
    if args.summary:
        out = pathlib.Path(args.summary)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(report.to_json() + "\n")
    return 1 if (args.fail_on_violation and not report.ok) else 0


if __name__ == "__main__":
    sys.exit(main())
