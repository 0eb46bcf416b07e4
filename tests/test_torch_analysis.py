"""The port's auditor (``repro_torch.analysis``, ``repro_torch.launch.audit``)
case for case against the reference's ``tests/test_analysis.py``: every
contract rule fires on a seeded violation and stays quiet on a clean twin,
the exempt modules stay exempt, waivers are reported, the real tree is
clean, the launch-budget checks pass the shipped kernels and fail an
inflated or misaligned model, the mirrored constants match the ``.cu``
sources, the run-time audit is clean on the real entry points and flags a
seeded one, the CLI gates (0 clean, 1 with a violation, 2 without a root),
and a report round-trips — byte for byte as the reference's."""

import json
import pathlib
import re
import shutil
import subprocess
import sys

import pytest

from repro_torch.analysis import vmem
from repro_torch.analysis.contracts import lint_source, lint_tree
from repro_torch.analysis.findings import (Finding, Report, split_suppressed,
                                           suppressed_rules)
from repro_torch.launch import audit

REPO = pathlib.Path(__file__).resolve().parent.parent
SRC_ROOT = REPO / "src" / "repro_torch"
CSRC = SRC_ROOT / "kernels" / "csrc"


def rules_of(findings):
    return sorted(f.rule for f in findings)


# ---------------------------------------------------------------- pass 1
# each case: (rule, seeded-violation snippet, clean twin)

CASES = [
    ("KC102",
     "def f(x):\n"
     "    lib = cuda.library('a1_count', SIG)\n"
     "    lib.a1_count_state(x.data_ptr())\n",
     "def f(x):\n"
     "    lib = cuda.library('a1_count', SIG)\n"
     "    lib.a1_count_state(x.data_ptr())\n"
     "    record_launch('a1_count_state')\n"),
    ("KC103",
     "def f(s):\n"
     "    lib = cuda.library('a2_count', SIG)\n"
     "    lib.a2_count_state(s.contiguous().data_ptr())\n"
     "    record_launch('a2_count_state')\n",
     "def f(s):\n"
     "    lib = cuda.library('a2_count', SIG)\n"
     "    lib.a2_count_state(s.data_ptr())\n"
     "    record_launch('a2_count_state')\n"),
    ("KC103",
     "def f(s):\n"
     "    lib = _lib()\n"
     "    tmp = s.clone()\n"
     "    getattr(lib, 'a2_count_state')(tmp.data_ptr())\n"
     "    record_launch('a2_count_state')\n"
     "    s.copy_(tmp)\n"
     "def _lib():\n"
     "    return cuda.library('a2_count', SIG)\n",
     "def f(s):\n"
     "    lib = _lib()\n"
     "    getattr(lib, 'a2_count_state')(s.data_ptr())\n"
     "    record_launch('a2_count_state')\n"
     "def _lib():\n"
     "    return cuda.library('a2_count', SIG)\n"),
    ("KC105",
     "def f(x):\n"
     "    try:\n"
     "        return a1_count_state(*x)\n"
     "    except RuntimeError:\n"
     "        return a1_count_state_plain(*x)\n",
     "def f(x):\n"
     "    try:\n"
     "        return a1_count_state(*x)\n"
     "    except RuntimeError as e:\n"
     "        raise RuntimeError('K2 failed') from e\n"),
    ("KC106",
     "import os\n"
     "T = os.environ.get('REPRO_POLICY_TABLE')\n",
     "from repro_torch.core.calibrate import get_policy\n"
     "T = get_policy()\n"),
    ("KC106",
     "import os\n"
     "T = os.getenv(calibrate.ENV_TABLE_DIR)\n",
     "import os\n"
     "T = os.getenv('HOME')\n"),
    ("KC107",
     "def f():\n"
     "    REGISTRY.counter('kernel_launches', kernel='a1').inc()\n",
     "def f():\n    record_launch('a1')\n"),
    ("KC107",
     "def f():\n    REGISTRY.clear_family('plain_calls')\n",
     "def f():\n    reset_counts()\n"),
]
IDS = [f"{c[0]}-{i}" for i, c in enumerate(CASES)]


@pytest.mark.parametrize("rule,bad,clean", CASES, ids=IDS)
def test_rule_fires_once_on_seeded_violation(rule, bad, clean):
    findings = lint_source(bad, "repro_torch/core/fixture.py")
    assert rules_of(findings) == [rule]


@pytest.mark.parametrize("rule,bad,clean", CASES, ids=IDS)
def test_rule_quiet_on_clean_twin(rule, bad, clean):
    assert lint_source(clean, "repro_torch/core/fixture.py") == []


def test_kc105_guards_only_kernels_and_core():
    """The counterpart of the reference's KC102 exemption: a plain version
    behind a failed launch is refused in ``kernels/`` and ``core/``, where
    the launches are, and not in the launchers, which may report it."""
    bad = CASES[3][1]
    assert rules_of(lint_source(bad, "repro_torch/kernels/x.py")) == \
        ["KC105"]
    assert lint_source(bad, "repro_torch/launch/x.py") == []


def test_env_accessor_module_exempt_from_kc106():
    src = "import os\nV = os.environ.get('REPRO_CALIBRATION_DIR')\n"
    assert lint_source(src, "repro_torch/core/calibrate.py") == []
    assert rules_of(lint_source(src, "repro_torch/core/x.py")) == ["KC106"]


def test_tally_accessor_module_exempt_from_kc107():
    src = ("def record_launch(kernel):\n"
           "    REGISTRY.counter('kernel_launches', kernel=kernel).inc()\n")
    assert lint_source(src, "repro_torch/kernels/tally.py") == []
    assert rules_of(lint_source(src, "repro_torch/core/x.py")) == ["KC107"]


def test_suppression_marker_waives_and_reports():
    bad = ("def f(x):\n"
           "    lib = cuda.library('a1_count', SIG)\n"
           "    lib.a1_lanes_resident_blocks(x)  # audit-ok: KC102 a query\n")
    findings = lint_source(bad, "repro_torch/kernels/x.py")
    active, waived = split_suppressed(
        findings, {"repro_torch/kernels/x.py": bad.splitlines()})
    assert active == [] and rules_of(waived) == ["KC102"]
    assert suppressed_rules("x = 1  # audit-ok: KC106") == {"KC106"}
    assert suppressed_rules("x = 1  # nothing here") == set()


def test_real_tree_is_clean():
    active, waived, summary = lint_tree(SRC_ROOT)
    assert active == [], [f.format() for f in active]
    assert summary["files_linted"] > 50
    # the waivers in place: the occupancy queries and the launches their
    # callers count
    assert rules_of(waived) == ["KC102"] * 4


# ---------------------------------------------------------------- pass 3


def test_vmem_policy_fits_budget():
    findings, summary = vmem.check_smem()
    assert findings == [], [f.format() for f in findings]
    assert 0 < summary["smem_worst_walk_bytes"] \
        <= summary["smem_budget_bytes"]
    # the fast templates and the generic instantiations, every kernel
    assert summary["smem_kernels_checked"] == 24


def test_vmem_flags_oversized_policy():
    findings, _ = vmem.check_smem(budget=16 * 1024)
    assert findings and set(rules_of(findings)) == {"VM301", "VM302"}


def test_vmem_flags_unaligned_policy(monkeypatch):
    monkeypatch.setattr(vmem, "K_CHUNK", 1000)
    assert "VM303" in rules_of(vmem.check_smem()[0])
    monkeypatch.setattr(vmem, "K_CHUNK", 1024)
    monkeypatch.setattr(vmem, "K_BUCKETS", 128)
    assert "VM303" in rules_of(vmem.check_smem()[0])


def test_vmem_footprint_monotone_in_staged_rows(monkeypatch):
    assert vmem.walk_smem(False) < vmem.map_smem(False) \
        < vmem.walk_smem(True) == vmem.map_smem(True)
    small = vmem.walk_smem(True)
    monkeypatch.setattr(vmem, "K_CHUNK", 4096)
    assert vmem.walk_smem(True) == 4 * small
    # 4 resident lane blocks of 4x the chunk overflow an SM
    assert "VM301" in rules_of(vmem.check_smem()[0])


def _cu_constants() -> dict[str, set[int]]:
    out: dict[str, set[int]] = {}
    for src in CSRC.glob("*.cu*"):
        for name, value in re.findall(r"constexpr int (k\w+) = (\d+);",
                                      src.read_text()):
            out.setdefault(name, set()).add(int(value))
    return out


def test_vmem_constants_match_kernel_layout():
    # the analysis plane mirrors the .cu constants instead of reading
    # them at run time; hold the mirror to the sources
    from repro_torch.kernels import cuda
    got = _cu_constants()
    assert got["kThreads"] == {vmem.K_THREADS}
    assert got["kChunk"] == {vmem.K_CHUNK}
    assert got["kBuckets"] == {vmem.K_BUCKETS}
    assert got["kLaneMinBlocks"] == {vmem.K_LANE_MIN_BLOCKS}
    assert got["kWarpSize"] == {vmem.WARP}
    assert list(vmem.FAST_LEVELS) == list(cuda.FAST_LEVELS)
    assert vmem.FAST_LCAPS == cuda.FAST_LCAPS
    assert cuda.LANE_TILE == vmem.K_THREADS


def test_segment_bricks_enforces_time_order():
    """The counterpart of the reference's admission bound: the Map walk
    takes any window length, and ends a machine at its first event past
    its window, so ``segment_bricks`` refuses events out of time order."""
    import numpy as np
    from repro_torch.kernels import ops
    wt = np.zeros((1, 4), np.int32)
    wtt = np.array([[1, 3, 2, 4]], np.int32)
    tau = np.array([0, 4], np.int64)
    with pytest.raises(ValueError):
        ops.segment_bricks(wt, wtt, tau, "cpu")


def test_vmem_pass_covers_calibration_grid():
    from repro_torch.core.calibrate import GridSpec
    pts = GridSpec().points()
    findings, summary = vmem.check_calibration_grid(pts)
    assert findings == []
    assert summary["smem_calibration_points"] == len(pts)
    assert 2 <= summary["smem_calibration_max_n"] <= 8
    # a grid reaching past the fast templates turns red
    findings, _ = vmem.check_calibration_grid(
        GridSpec(episode_sizes=(3, 9)).points())
    assert findings and all(f.rule == "VM304" for f in findings)
    assert vmem.check_calibration_grid(pts, lcap=3)[0]


# ---------------------------------------------------------------- pass 2


def test_trace_audit_clean_on_real_entry_points():
    from repro_torch.analysis import tracecheck
    findings, summary = tracecheck.audit_entry_points()
    assert findings == [], [f.format() for f in findings]
    assert len(summary["entry_points_run"]) >= 20


def test_entry_audit_flags_dtype_and_reallocated_state():
    import torch
    from repro_torch.analysis.tracecheck import audit_entries
    state = [torch.zeros(3, dtype=torch.int32)]

    def leaky():
        state[0] = state[0] + 1  # a new tensor, not advanced in place
        return [state[0].to(torch.float32)]

    frozen = [torch.zeros(3, dtype=torch.int32)]
    rules = rules_of(audit_entries(
        {"leaky": (leaky, list(state)), "frozen": (lambda: [], frozen)},
        "cpu", "seeded"))
    assert rules == ["TR202", "TR204", "TR204"]


def test_traffic_audit_totals_under_reference_keys():
    """Pass 2's ``hlo_traffic``: the op-analysis totals of the plain A1 and
    A2 counters under the keys of the reference's ``audit_hlo``, each with
    the reference's five fields, traffic > 0 and no contraction."""
    from repro_torch.analysis import tracecheck
    findings, summary = tracecheck.audit_traffic()
    assert findings == []
    traffic = summary["hlo_traffic"]
    assert set(traffic) == {"count_a1._a1_scan_core",
                            "count_a2._a2_scan_core"}
    for totals in traffic.values():
        assert set(totals) == {"collective_bytes", "collective_breakdown",
                               "dot_flops", "while_trip_counts",
                               "traffic_bytes"}
        assert totals["traffic_bytes"] > 0 and totals["dot_flops"] == 0
        assert totals["collective_bytes"] == 0


def test_library_sentinel_passes_on_the_cpu():
    from repro_torch.analysis import tracecheck
    findings, summary = tracecheck.library_sentinel(n_windows=4)
    assert findings == []
    assert summary["library_calls_cpu"] == 0


# ------------------------------------------------------------------ CLI


def run_cli(*args):
    import os
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.audit", *args],
        capture_output=True, text=True, env=env, cwd=REPO)


def test_cli_clean_tree_exits_zero(tmp_path):
    out = tmp_path / "summary.json"
    r = run_cli("--fail-on-violation", "--skip-trace", "--summary", str(out))
    assert r.returncode == 0, r.stdout + r.stderr
    assert "AUDIT CLEAN" in r.stdout
    data = json.loads(out.read_text())
    assert data["ok"] and data["findings"] == []
    assert data["summary"]["kernel_calls"] == {}
    assert r.stdout.count("[suppressed]") == 4


def test_cli_full_audit_clean_on_the_cpu(capsys):
    """Every pass, the run-time one included (on the CPU: entry points,
    the library sentinel; the synchronisation audit needs the card)."""
    code = audit.main(["--fail-on-violation", "--json"])
    data = json.loads(capsys.readouterr().out)
    assert code == 0, data["findings"]
    assert data["summary"]["library_calls_cpu"] == 0
    assert len(data["summary"]["entry_points_run"]) >= 20
    assert set(data["summary"]["hlo_traffic"]) == {
        "count_a1._a1_scan_core", "count_a2._a2_scan_core"}


def test_cli_budget_gates_the_launch_budget(capsys):
    """``--budget-mib`` sets a block's shared-memory budget: below the
    walks' staging every launch is over it (VM301, VM302), exit 1."""
    code = audit.main(["--fail-on-violation", "--skip-trace",
                       "--budget-mib", "0.01"])
    out = capsys.readouterr().out
    assert code == 1
    assert "VM301" in out and "VM302" in out


def test_cli_missing_root_exits_two(tmp_path):
    r = run_cli("--skip-trace", "--root", str(tmp_path / "nowhere"))
    assert r.returncode == 2
    assert "not found" in r.stderr


@pytest.mark.parametrize("rule,bad,clean", CASES, ids=IDS)
def test_cli_injected_violation_exits_nonzero(tmp_path, capsys, rule, bad,
                                              clean):
    root = tmp_path / "repro_torch"
    shutil.copytree(SRC_ROOT, root,
                    ignore=shutil.ignore_patterns("__pycache__", "csrc"))
    (root / "core" / "injected_fixture.py").write_text(bad)
    code = audit.main(["--fail-on-violation", "--skip-trace", "--root",
                       str(root)])
    out = capsys.readouterr().out
    assert code == 1, out
    assert rule in out and "injected_fixture.py" in out


def test_cli_without_fail_flag_never_gates(tmp_path, capsys):
    root = tmp_path / "repro_torch"
    shutil.copytree(SRC_ROOT, root,
                    ignore=shutil.ignore_patterns("__pycache__", "csrc"))
    (root / "core" / "injected_fixture.py").write_text(CASES[0][1])
    code = audit.main(["--skip-trace", "--root", str(root), "--json"])
    data = json.loads(capsys.readouterr().out)
    assert code == 0
    assert not data["ok"] and rules_of(
        Finding(**f) for f in data["findings"]) == ["KC102"]


# ------------------------------------------------------------- findings


def test_report_roundtrip():
    rep = Report()
    rep.extend([Finding("KC102", "a.py", 3, "msg")],
               [Finding("KC106", "b.py", 9, "waived")], files_linted=2)
    assert not rep.ok
    data = json.loads(rep.to_json())
    assert data["findings"][0]["rule"] == "KC102"
    assert data["suppressed"][0]["line"] == 9
    assert data["summary"]["files_linted"] == 2
    assert "AUDIT FAILED" in rep.format()
    # the same findings give the reference's report byte for byte
    from repro.analysis import findings as ref
    twin = ref.Report()
    twin.extend([ref.Finding("KC102", "a.py", 3, "msg")],
                [ref.Finding("KC106", "b.py", 9, "waived")],
                files_linted=2)
    assert twin.to_json() == rep.to_json()
    assert twin.format() == rep.format()
