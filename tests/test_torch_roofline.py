"""The port's roofline (``repro_torch.launch.roofline``) against the
reference's (``repro.launch.roofline``) on the same dry-run records, with
the reference's hardware constants swapped for the H100's inside each
test (``monkeypatch``; no file of the reference changes): every key the
two share is equal to 1e-12 relative, and ``fits_80g`` (the card's 80
GiB) takes the place of the reference's ``fits_16g``. Then
``load_cells`` over ``ok``, ``skip`` and ``error`` records,
``to_markdown``'s rows, and the CLI's two outputs."""

import copy
import json
import math

import pytest

from repro.launch import roofline as ref_roofline
from repro_torch.launch import roofline


def _rec(**over):
    """``tests/test_launch.py``'s record, with ``over`` merged in."""
    rec = {
        "status": "ok", "chips": 256, "arch": "x", "shape": "train_4k",
        "mesh": "single", "tokens": 1000,
        "hlo": {"dot_flops": 1e15, "traffic_bytes": 1e12,
                "collective_bytes": 1e11, "collective_breakdown": {}},
        "cost": {"flops": 1e13, "bytes accessed": 1e10},
        "memory": {"per_device_total_bytes": 8 * 2 ** 30},
        "model": {"params": 1e9, "active_params": 1e9, "seq_len": 4096,
                  "global_batch": 256, "kind": "train"},
    }
    for key, value in over.items():
        if isinstance(value, dict):
            rec[key] = {**rec[key], **value}
        else:
            rec[key] = value
    return rec


RECORDS = {
    "compute": _rec(),
    "collective": _rec(hlo={"dot_flops": 1e12, "collective_bytes": 5e12,
                            "collective_breakdown": {
                                "all-gather": 3e12,
                                "reduce-scatter": 2e12}}),
    "memory": _rec(shape="prefill_32k",
                   hlo={"dot_flops": 1e12, "traffic_bytes": 4e13},
                   model={"kind": "prefill"}),
    "decode": _rec(shape="decode_32k", chips=512, mesh="multi", tokens=128,
                   hlo={"dot_flops": 3e9, "traffic_bytes": 2e11,
                        "collective_bytes": 1e8},
                   cost={"flops": 3e9, "bytes accessed": 2e11},
                   memory={"per_device_total_bytes": 100 * 2 ** 30},
                   model={"kind": "decode", "active_params": 3e9}),
}


@pytest.fixture
def h100(monkeypatch):
    for name in ("PEAK_FLOPS", "HBM_BW", "ICI_BW"):
        monkeypatch.setattr(ref_roofline, name, getattr(roofline, name))


def test_constants_are_the_h100s():
    assert roofline.PEAK_FLOPS == 989e12
    assert roofline.HBM_BW == 3.35e12
    assert roofline.ICI_BW == 450e9


@pytest.mark.parametrize("kind", list(RECORDS))
def test_cell_terms_match_reference(h100, kind):
    rec = RECORDS[kind]
    want = ref_roofline.cell_terms(copy.deepcopy(rec))
    got = roofline.cell_terms(copy.deepcopy(rec))
    shared = set(want) & set(got)
    assert set(want) - shared == {"fits_16g"}
    assert set(got) - shared == {"fits_80g"}
    for key in shared:
        a, b = got[key], want[key]
        if isinstance(b, float):
            assert math.isclose(a, b, rel_tol=1e-12, abs_tol=0.0), key
        else:
            assert a == b, key
    assert got["dominant"] == (kind if kind != "decode" else "memory")


@pytest.mark.parametrize("gib,fits", [(79.99, True), (80, False),
                                      (80.01, False), (16.5, True)])
def test_fits_80g_follows_total_bytes(gib, fits):
    rec = _rec(memory={"per_device_total_bytes": int(gib * 2 ** 30)})
    got = roofline.cell_terms(rec)
    assert got["fits_80g"] is fits
    assert got["mem_gib_dev"] == int(gib * 2 ** 30) / 2 ** 30


def _write_cells(d):
    recs = {"a__train_4k__single.json": {**RECORDS["compute"], "arch": "a"},
            "b__decode_32k__multi.json": {**RECORDS["decode"], "arch": "b"},
            "c__long_500k__single.json": {
                "status": "skip", "arch": "c", "shape": "long_500k",
                "mesh": "single", "reason": "no sub-quadratic path"},
            "d__train_4k__single.json": {
                "status": "error", "arch": "d", "shape": "train_4k",
                "mesh": "single", "error": "boom"}}
    for name, rec in recs.items():
        (d / name).write_text(json.dumps(rec))
    (d / "a__train_4k__single.ops.txt").write_text("not a record\n")


def test_load_cells_ok_skip_error(tmp_path):
    _write_cells(tmp_path)
    cells = roofline.load_cells(tmp_path)
    assert [c["arch"] for c in cells] == ["a", "b", "c"]
    assert cells[2] == {"arch": "c", "shape": "long_500k",
                        "mesh": "single", "skip": "no sub-quadratic path"}
    assert cells[0] == roofline.cell_terms({**RECORDS["compute"],
                                            "arch": "a"})


def test_to_markdown_rows_and_numbers(tmp_path):
    _write_cells(tmp_path)
    cells = roofline.load_cells(tmp_path)
    lines = roofline.to_markdown(cells).splitlines()
    rows = [ln for ln in lines if ln.startswith("| ")]
    assert len(rows) == 4  # header and three cells
    a = cells[0]
    assert rows[1] == (
        f"| a | train_4k | single | {a['compute_s']:.3e} "
        f"| {a['memory_s']:.3e} | {a['collective_s']:.3e} | **compute** "
        f"| {a['mfu_bound']:.2%} | {a['useful_flops_ratio']:.2f} | 8.0 "
        f"| ✓ |")
    assert rows[2].endswith("| 100.0 | ✗ |")
    assert rows[3] == ("| c | long_500k | single | — | — | — | SKIP | — | "
                       "— | — | — |")
    assert lines[-1] == roofline.CAVEAT


def test_cli_writes_json_and_markdown(tmp_path, capsys):
    d = tmp_path / "dr"
    d.mkdir()
    _write_cells(d)
    out_json, out_md = tmp_path / "o" / "r.json", tmp_path / "o" / "r.md"
    assert roofline.main(["--dir", str(d), "--json", str(out_json),
                          "--markdown", str(out_md),
                          "--mesh", "single"]) == 0
    cells = json.loads(out_json.read_text())
    assert [c["arch"] for c in cells] == ["a", "c"]
    md = out_md.read_text()
    assert md == roofline.to_markdown(cells) + "\n"
    assert "| a | train_4k | single |" in capsys.readouterr().out


def test_module_needs_no_torch():
    import ast
    top = set()
    for node in ast.parse(open(roofline.__file__).read()).body:
        if isinstance(node, ast.Import):
            top |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            top.add((node.module or "").split(".")[0])
    assert top <= {"__future__", "argparse", "json", "pathlib"}
