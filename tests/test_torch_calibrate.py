"""Calibrated dispatch in the port (``repro_torch.core.calibrate``), case for
case with the reference's ``tests/test_calibrate.py`` where the port has the
counterpart, and held against the reference (``repro.core.calibrate``) on
the same inputs. Tolerance: exact equality — integers, and floats that come
from the same numpy calls on the same inputs.

The load-bearing claims:

* the model (features, analytic seed, weighted least-squares fit) and the
  table document are the reference's: the same points give the same
  coefficients, and a document decodes in either package;
* for one table, both packages pick the same engine and segment count
  (the reference's kernel probe pinned on, as one card with the kernel
  does); with no table, both are Eq. 2;
* a table steers only calls on a device with its fingerprint — a stale
  or foreign table degrades to the heuristic — and installing one leaves
  every one-shot count unchanged. A streaming counter's engine decides
  which window an occurrence is reported in (the segment-parallel commits
  trail the window by W, in the reference too), so a ``per_window``
  miner's windows equal the heuristic's where the table keeps its
  engines.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.core import calibrate as ref_cal
from repro.core import hybrid as ref_hybrid
from repro.core import StreamingMiner as RefMiner
from repro.data import partition_windows as ref_windows
from repro.data import sym26 as ref_sym26
from repro.obs import REGISTRY as REF_REGISTRY
from repro_torch.core import (EpisodeBatch, EventStream, StreamingMiner,
                              calibrate, hybrid)
from repro_torch.core.calibrate import (CalibrationTable, DispatchPolicy,
                                        FEATURE_NAMES, GridSpec,
                                        analytic_seconds, features,
                                        fit_table, install_table, load_table)
from repro_torch.data import partition_windows, sym26
from repro_torch.obs import REGISTRY

torch.set_num_threads(1)

CPU = "cpu"
HW = {"peak_flops": 197e12, "hbm_bw": 819e9, "ici_bw": 50e9}
CARD = "cuda:NVIDIA H100 80GB HBM3x1/shards1"


@pytest.fixture(autouse=True)
def _hermetic_policy():
    """Every test starts (and leaves) both processes' policies on the
    heuristic, with no decision counted."""
    for cal, reg in ((calibrate, REGISTRY), (ref_cal, REF_REGISTRY)):
        cal.clear_policy()
        reg.clear_family("dispatch_policy_total")
    yield
    for cal, reg in ((calibrate, REGISTRY), (ref_cal, REF_REGISTRY)):
        cal.clear_policy()
        reg.clear_family("dispatch_policy_total")


@pytest.fixture
def ref_kernel_probe(monkeypatch):
    """Pin the reference's segmented-kernel probe on: its candidates and
    crossover then are those of one card with the kernel (the port's)."""
    monkeypatch.setattr(ref_hybrid, "_mapc_kernel_available", lambda: True)


def small_stream(n=64, num_types=5, seed=0):
    rng = np.random.default_rng(seed)
    return EventStream(
        types=rng.integers(0, num_types, size=n).astype(np.int32),
        times=np.cumsum(rng.integers(1, 3, size=n)).astype(np.int32),
        num_types=num_types)


def small_eps(m=4, n=3, num_types=5, seed=1):
    rng = np.random.default_rng(seed)
    et = rng.integers(0, num_types, size=(m, n)).astype(np.int32)
    tlo = np.full((m, n - 1), 1, np.int32)
    thi = np.full((m, n - 1), 8, np.int32)
    return EpisodeBatch(et, tlo, thi)


def synth_points(true, n_events=(1024, 4096), seed=0):
    """Grid timings generated from known per-engine linear models."""
    rng = np.random.default_rng(seed)
    pts = []
    for engine, coef in true.items():
        for n_ep in (2, 3, 5):
            for m in (16, 128, 512):
                for n_ev in n_events:
                    for q in ((1,) if engine == "ptpe" else (1, 4, 8)):
                        a = analytic_seconds(engine, n_ep, m, n_ev, q,
                                             1, HW)
                        phi = features(n_ep, m, n_ev, q, a)
                        y = sum(c * x for c, x in zip(coef, phi))
                        y *= 1.0 + rng.uniform(-0.01, 0.01)
                        pts.append({"engine": engine, "n_episode": n_ep,
                                    "m": m, "n_events": n_ev, "q": q,
                                    "devices": 1, "seconds": y})
    return pts


def make_table(true, device_kind=calibrate.CPU_FINGERPRINT):
    return fit_table(synth_points(true), HW, device_kind=device_kind)


# ptpe flat-ish; mapconcatenate cheap on events but scales with cells —
# so low M prefers mapc, high M prefers ptpe (the fig7 shape)
TRUE = {
    "ptpe": [2e-3, 1e-3, 1e-4, 1e-5, 0.0, 0.0],
    "mapconcatenate": [1e-3, 2e-4, 5e-3, 1e-4, 2e-4, 0.0],
}
# every engine the port runs on a 4-shard mesh, each with its own shape
TRUE4 = dict(TRUE, mapconcat_kernel=[8e-4, 3e-4, 4e-3, 8e-5, -1e-4, 0.0],
             mapconcat_sharded=[1.5e-3, 1e-4, 2e-3, 5e-5, 1e-4, 0.0])


# ------------------------------------------------------------ model + fit


def test_analytic_seconds_engine_shape():
    kw = dict(n_episode=3, m=128, n_events=4096, q=8, devices=4, hw=HW)
    t = {e: analytic_seconds(e, kw["n_episode"], kw["m"], kw["n_events"],
                             kw["q"], kw["devices"], kw["hw"])
         for e in calibrate.ENGINES}
    # the kernel halves effective traffic; sharding divides it by devices
    assert t["mapconcat_kernel"] < t["mapconcatenate"]
    assert t["mapconcat_sharded"] < t["mapconcat_kernel"]
    assert t["ptpe"] < t["mapconcatenate"]
    with pytest.raises(ValueError):
        analytic_seconds("nope", 3, 128, 4096, 8, 1, HW)


def test_constants_and_model_match_reference():
    """``features``/``analytic_seconds`` over every point of the full grid
    (and 1, 2, 4 devices), the grids and the schema constants."""
    assert calibrate.SCHEMA_VERSION == ref_cal.SCHEMA_VERSION
    assert calibrate.CODE_VERSION == ref_cal.CODE_VERSION
    assert calibrate.FEATURE_NAMES == ref_cal.FEATURE_NAMES
    assert calibrate.ENGINES == ref_cal.ENGINES
    for spec, ref_spec in ((GridSpec(), ref_cal.GridSpec()),
                           (GridSpec.smoke(), ref_cal.GridSpec.smoke())):
        assert spec.points() == ref_spec.points()
    for n_ep, m, n_ev, q, _ in GridSpec().points():
        for d in (1, 2, 4):
            for e in calibrate.ENGINES:
                a = analytic_seconds(e, n_ep, m, n_ev, q, d, HW)
                assert a == ref_cal.analytic_seconds(e, n_ep, m, n_ev, q,
                                                     d, HW)
                assert features(n_ep, m, n_ev, q, a) == \
                    ref_cal.features(n_ep, m, n_ev, q, a)


def test_fit_recovers_relative_ordering():
    table = make_table(TRUE)
    assert set(table.coeffs) == set(TRUE)
    for engine, coef in TRUE.items():
        for (n_ep, m, n_ev) in ((2, 16, 1024), (5, 512, 4096)):
            a = analytic_seconds(engine, n_ep, m, n_ev, 1, 1, HW)
            truth = sum(c * x for c, x in
                        zip(coef, features(n_ep, m, n_ev, 1, a)))
            got = table.predict(engine, n_episode=n_ep, m=m,
                                n_events=n_ev, q=1)
            assert got == pytest.approx(truth, rel=0.15)


def test_fit_matches_reference_coefficients():
    """The same points give the same coefficients in both packages."""
    pts = synth_points(TRUE4)
    port = fit_table(pts, HW, device_kind="k")
    ref = ref_cal.fit_table(pts, HW, device_kind="k")
    assert port.coeffs == ref.coeffs
    assert port.segment_counts == ref.segment_counts
    assert port.to_doc() == ref.to_doc()


def test_predict_unmeasured_engine_is_none():
    table = make_table(TRUE)
    assert table.predict("mapconcat_kernel", n_episode=3, m=16,
                         n_events=1024) is None


# ----------------------------------------------- cache + invalidation


def test_table_roundtrip(tmp_path):
    table = make_table(TRUE)
    path = str(tmp_path / "cal" / "t.json")
    table.save(path)
    back = load_table(path)
    assert back is not None
    assert back.device_kind == table.device_kind
    assert back.coeffs == table.coeffs
    assert back.segment_counts == table.segment_counts


@pytest.mark.parametrize("direction", ["port_to_ref", "ref_to_port"])
def test_table_doc_crosses_packages(tmp_path, direction):
    """A document written by one package decodes in the other with every
    field and prediction equal."""
    pts = synth_points(TRUE4)
    path = str(tmp_path / "t.json")
    if direction == "port_to_ref":
        fit_table(pts, HW, device_kind=CARD).save(path)
        src = load_table(path)
        dst = ref_cal.CalibrationTable.from_doc(json.load(open(path)))
    else:
        ref_cal.fit_table(pts, HW, device_kind=CARD).save(path)
        src = ref_cal.load_table(path)
        dst = CalibrationTable.from_doc(json.load(open(path)))
    assert dst is not None and dst.to_doc() == src.to_doc()
    for e in calibrate.ENGINES:
        for n_ep, m, n_ev, q, _ in GridSpec.smoke().points():
            assert dst.predict(e, n_episode=n_ep, m=m, n_events=n_ev, q=q,
                               devices=4) == \
                src.predict(e, n_episode=n_ep, m=m, n_events=n_ev, q=q,
                            devices=4)


@pytest.mark.parametrize("corrupt", [
    lambda d: d.update(schema=99),
    lambda d: d.update(code_version="cal0-ancient"),
    lambda d: d["coeffs"].update(ptpe=[1.0, 2.0]),  # wrong feature dim
    lambda d: d.pop("device_kind"),
])
def test_stale_table_is_rejected(tmp_path, corrupt):
    doc = make_table(TRUE).to_doc()
    corrupt(doc)
    path = tmp_path / "t.json"
    path.write_text(json.dumps(doc))
    assert load_table(str(path)) is None
    assert ref_cal.load_table(str(path)) is None


def test_load_missing_or_garbage(tmp_path):
    assert load_table(str(tmp_path / "absent.json")) is None
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    assert load_table(str(bad)) is None


def test_install_wrong_device_degrades_to_heuristic(tmp_path):
    table = make_table(TRUE, device_kind=CARD)
    path = str(tmp_path / "t.json")
    table.save(path)
    pol = install_table(path, device=CPU)
    assert pol.table is None and pol.source == "heuristic"
    # ... and without the match requirement it is installed, but still
    # steers no call on a device of another fingerprint
    pol = install_table(path, require_device_match=False, device=CPU)
    assert pol.table is not None and pol.source == "calibrated"
    c = pol.choose(n_events=4096, n_episode=3, m=16, device=CPU)
    assert c.source == "heuristic"
    assert pol.choose_stream(n_episode=3, m=16,
                             device=CPU).source == "heuristic"
    assert pol.choose_segments([8, 4, 1], engine="mapconcat_kernel",
                               n_episode=3, m=16, n_events=4096,
                               device=CPU) == (8, "heuristic")
    assert pol.predict_single("ptpe", n_episode=3, m=16,
                              device=CPU) is None


def test_fingerprints_name_the_device(monkeypatch):
    assert calibrate.device_fingerprint(CPU) == "cpu:plain"
    assert calibrate.device_fingerprint(torch.device("cpu", 0)) == \
        "cpu:plain"
    # with no card, the default device is the host
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert calibrate.device_fingerprint() == "cpu:plain"


def test_env_table_opt_in(tmp_path, monkeypatch):
    table = make_table(TRUE, device_kind=calibrate.device_fingerprint(CPU))
    path = str(tmp_path / "t.json")
    table.save(path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv(calibrate.ENV_TABLE, path)
    calibrate.clear_policy()
    assert calibrate.get_policy().source == "calibrated"
    monkeypatch.setenv(calibrate.ENV_TABLE, str(tmp_path / "absent.json"))
    calibrate.clear_policy()
    assert calibrate.get_policy().source == "heuristic"
    # a card's table never steers the host
    make_table(TRUE, device_kind=CARD).save(path)
    monkeypatch.setenv(calibrate.ENV_TABLE, path)
    calibrate.clear_policy()
    assert calibrate.get_policy().source == "heuristic"


def test_env_dir_opt_in(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv(calibrate.ENV_TABLE_DIR, str(tmp_path))
    calibrate.clear_policy()
    assert calibrate.get_policy().source == "heuristic"  # nothing cached
    make_table(TRUE).save(calibrate.default_table_path(device=CPU))
    assert calibrate.default_table_path() == str(tmp_path / "cpu_plain.json")
    calibrate.clear_policy()
    pol = calibrate.get_policy()
    assert pol.source == "calibrated"
    assert pol.path == str(tmp_path / "cpu_plain.json")


def test_default_table_path_is_fingerprint_scoped(monkeypatch):
    monkeypatch.setenv(calibrate.ENV_TABLE_DIR, "/cal")
    p = calibrate.default_table_path(device=CPU)
    assert p.startswith("/cal/") and p.endswith(".json")
    assert "/" not in p[len("/cal/"):]


# ------------------------------------------------------------- policy


def test_heuristic_parity_with_eq2(monkeypatch):
    """No table: choose() must reproduce hybrid's Eq. 2 exactly."""
    pol = DispatchPolicy()
    monkeypatch.setattr(hybrid, "crossover", lambda n, device=None: 100)
    # above crossover, short stream -> ptpe
    c = pol.choose(n_events=512, n_episode=3, m=512, device=CPU)
    assert (c.engine, c.source) == ("ptpe", "heuristic")
    # below crossover, short stream -> mapconcatenate
    c = pol.choose(n_events=512, n_episode=3, m=16, device=CPU)
    assert c.engine == "mapconcatenate"
    # long stream + small batch -> the segmented kernel
    c = pol.choose(n_events=4096, n_episode=3, m=16, device=CPU)
    assert c.engine == "mapconcat_kernel"
    # ... upgraded to the sharded form on a multi-device mesh
    c = pol.choose(n_events=4096, n_episode=3, m=16, shard_devices=4,
                   device=CPU)
    assert c.engine == "mapconcat_sharded"
    # long stream, many episodes -> ptpe
    c = pol.choose(n_events=4096, n_episode=3, m=512, device=CPU)
    assert c.engine == "ptpe"


def test_regression_fig7_many_episode_rows_pin_ptpe():
    """The reference's fig7 N3_M512/N5_M512 pin: on one device the
    heuristic hands M=512 to PTPE."""
    pol = DispatchPolicy()
    for n in (3, 5):
        c = pol.choose(n_events=20000, n_episode=n, m=512,
                       shard_devices=1, device=CPU)
        assert c.engine == "ptpe", f"N{n}_M512 regressed to {c.engine}"


def test_calibrated_choice_is_argmin_and_cached():
    pol = DispatchPolicy(make_table(TRUE))
    lo = pol.choose(n_events=4096, n_episode=3, m=16, device=CPU)
    hi = pol.choose(n_events=4096, n_episode=3, m=512, device=CPU)
    assert lo.source == hi.source == "calibrated"
    assert lo.engine == "mapconcatenate"
    assert hi.engine == "ptpe"
    assert hi.predicted_s == pol.table.predict(
        "ptpe", n_episode=3, m=512, n_events=4096, q=1)
    # same shape -> cached decision object, and n is bucketed
    assert pol.choose(n_events=4000, n_episode=3, m=512,
                      device=CPU) is hi


def test_calibrated_never_picks_unavailable_engine():
    """The sharded engine only where the mesh holds more than one shard,
    however cheap the table says it is."""
    rigged = dict(TRUE4, mapconcat_sharded=[1e-7, 0, 0, 0, 0, 0])
    pol = DispatchPolicy(make_table(rigged))
    for m in (16, 128, 512):
        c = pol.choose(n_events=4096, n_episode=3, m=m, device=CPU)
        assert c.engine != "mapconcat_sharded"
        c = pol.choose(n_events=4096, n_episode=3, m=m, shard_devices=2,
                       device=CPU)
        assert c.engine == "mapconcat_sharded"


def test_choose_stream_matches_regimes(monkeypatch):
    pol = DispatchPolicy(make_table(TRUE))
    assert pol.choose_stream(n_episode=3, m=512, device=CPU).engine == "ptpe"
    assert pol.choose_stream(n_episode=3, m=16,
                             device=CPU).engine == "mapconcatenate"
    # heuristic branch defers to Eq. 2
    monkeypatch.setattr(hybrid, "crossover", lambda n, device=None: 100)
    heur = DispatchPolicy()
    assert heur.choose_stream(n_episode=3, m=512, device=CPU).engine == "ptpe"
    assert heur.choose_stream(n_episode=3, m=16,
                              device=CPU).engine == "mapconcatenate"


def test_choose_segments_heuristic_keeps_caller_preference():
    pol = DispatchPolicy()
    q, src = pol.choose_segments([8, 4, 1], engine="mapconcatenate",
                                 n_episode=3, m=16, n_events=4096,
                                 device=CPU)
    assert (q, src) == (8, "heuristic")
    with pytest.raises(ValueError):
        pol.choose_segments([], engine="mapconcatenate", n_episode=3,
                            m=16, n_events=4096, device=CPU)


def test_choose_segments_calibrated_scores_candidates():
    pol = DispatchPolicy(make_table(TRUE))
    q, src = pol.choose_segments([8, 4, 1], engine="mapconcatenate",
                                 n_episode=3, m=16, n_events=4096,
                                 device=CPU)
    assert src == "calibrated"
    best = min((pol.table.predict("mapconcatenate", n_episode=3, m=16,
                                  n_events=4096, q=c), c)
               for c in (8, 4, 1))[1]
    assert q == best


def test_predict_single_none_under_heuristic():
    assert DispatchPolicy().predict_single(
        "ptpe", n_episode=3, m=16, device=CPU) is None
    got = DispatchPolicy(make_table(TRUE)).predict_single(
        "ptpe", n_episode=3, m=16, device=CPU)
    assert got is not None and got > 0


def test_decisions_exported_to_registry():
    pol = DispatchPolicy()
    for _ in range(3):
        pol.choose(n_events=4096, n_episode=3, m=512, device=CPU)
    stats = pol.stats()
    assert stats["source"] == "heuristic"
    assert stats["decisions"] == {"ptpe/heuristic": 3}


# ------------------------------------------- against the reference's policy


astuple = dataclasses.astuple


def _sweep():
    for n_ep in range(2, 9):
        for m in (1, 16, 100, 128, 129, 512, 4096):
            for n_ev in (512, 2048, 8192):
                for d in (1, 2, 4):
                    yield n_ep, m, n_ev, d


@pytest.mark.parametrize("with_table", [False, True])
def test_choices_match_reference(ref_kernel_probe, with_table):
    """One table (or none) in both packages: every choice over the sweep
    is the same engine, segment count, source and prediction."""
    table = make_table(TRUE4) if with_table else None
    port = DispatchPolicy(table)
    ref = ref_cal.DispatchPolicy(
        ref_cal.CalibrationTable.from_doc(table.to_doc()) if table else None)
    for n_ep, m, n_ev, d in _sweep():
        a = port.choose(n_events=n_ev, n_episode=n_ep, m=m, shard_devices=d,
                        default_segments=8, device=CPU)
        b = ref.choose(n_events=n_ev, n_episode=n_ep, m=m, use_kernel=True,
                       kernel_ok=True, shard_devices=d, default_segments=8)
        assert astuple(a) == astuple(b), (n_ep, m, n_ev, d)
        a = port.choose_stream(n_episode=n_ep, m=m, shard_devices=d,
                               device=CPU)
        b = ref.choose_stream(n_episode=n_ep, m=m, use_kernel=True,
                              kernel_ok=True, shard_devices=d)
        assert astuple(a) == astuple(b), (n_ep, m, d)
        for engine in ("mapconcatenate", "mapconcat_kernel",
                       "mapconcat_sharded"):
            got = port.choose_segments([8, 4, 2, 1], engine=engine,
                                       n_episode=n_ep, m=m, n_events=n_ev,
                                       devices=d, device=CPU)
            assert got == ref.choose_segments(
                [8, 4, 2, 1], engine=engine, n_episode=n_ep, m=m,
                n_events=n_ev, devices=d), (engine, n_ep, m, n_ev, d)
        for engine in calibrate.ENGINES:
            assert port.predict_single(
                engine, n_episode=n_ep, m=m, n_events=n_ev, q=4, devices=d,
                device=CPU) == ref.predict_single(
                    engine, n_episode=n_ep, m=m, n_events=n_ev, q=4,
                    devices=d)
    if with_table:
        assert port.stats()["decisions"] == \
            ref.stats()["decisions"]


# ------------------------------------------------- consult-point wiring


@pytest.mark.parametrize("winner", ["ptpe", "mapconcatenate",
                                    "mapconcat_kernel"])
def test_hybrid_dispatch_bit_identical_across_policy(winner):
    """``count_dispatch(engine="hybrid")`` counts equal with no table and
    with a table rigged so that each engine wins."""
    stream, eps = small_stream(), small_eps()
    want = np.asarray(hybrid.count_dispatch(stream, eps, engine="ptpe",
                                            device=CPU))
    got_heur = np.asarray(hybrid.count_dispatch(stream, eps,
                                                engine="hybrid", device=CPU))
    rig = {e: [1.0, 0, 0, 0, 0, 0] for e in
           ("ptpe", "mapconcatenate", "mapconcat_kernel")}
    rig[winner] = [1e-6, 0, 0, 0, 0, 0]
    calibrate.set_policy(DispatchPolicy(make_table(rig)))
    got_cal = np.asarray(hybrid.count_dispatch(stream, eps, engine="hybrid",
                                               device=CPU))
    np.testing.assert_array_equal(want, got_heur)
    np.testing.assert_array_equal(want, got_cal)
    dec = calibrate.policy_stats()["decisions"]
    assert dec.get(f"{winner}/calibrated", 0) >= 1


def test_crossover_capacity_and_kernel_aware(monkeypatch):
    monkeypatch.setattr(hybrid, "parallel_units", lambda device=None: 1)
    monkeypatch.setattr(hybrid, "_mapc_kernel_available", lambda: False)
    assert hybrid.crossover(4) == 0
    # the segmented kernel gives a lone device one real segment axis
    monkeypatch.setattr(hybrid, "_mapc_kernel_available", lambda: True)
    assert hybrid.crossover(4) == int(hybrid.f_of_n(4))
    monkeypatch.setattr(hybrid, "parallel_units", lambda device=None: 8)
    assert hybrid.crossover(2) > hybrid.crossover(8) > 0


def test_batcher_prior_decodes_seam_keys():
    """All four of the port's seam kinds; M comes from the lanes."""
    from repro_torch.service.batcher import _policy_prior
    assert _policy_prior(("a1k", 3, 4), [16], CPU) is None  # heuristic
    pol = DispatchPolicy(make_table(TRUE4))
    calibrate.set_policy(pol)
    for key, engine, q, d in ((("a2k", 3), "ptpe", 1, 1),
                              (("a1k", 3, 4), "ptpe", 1, 1),
                              (("mapck", 3, 4, 8), "mapconcat_kernel", 8, 1),
                              (("mapcs", 3, 4, 8, (CPU,) * 4),
                               "mapconcat_sharded", 8, 4)):
        got = _policy_prior(key, [16, 48], CPU)
        want = [pol.predict_single(engine, n_episode=3, m=m, q=q, devices=d,
                                   device=CPU) for m in (16, 48)]
        assert got is not None and got == sum(want) / 2, key
    assert _policy_prior(("a1k", 3, 4), [], CPU) is None
    assert _policy_prior(("a1", 16, 3, 4), [16], CPU) is None  # no port seam
    # a table of another device steers no prior
    calibrate.set_policy(DispatchPolicy(make_table(TRUE4, device_kind=CARD)))
    assert _policy_prior(("a1k", 3, 4), [16], CPU) is None


def test_fusion_gate_counts_calibrated_prior():
    from repro_torch.service.batcher import FusionCostModel, _policy_prior
    calibrate.set_policy(DispatchPolicy(make_table(TRUE4)))
    REGISTRY.clear_family("batcher_fusion_prior_total")
    gate = FusionCostModel(prior=_policy_prior)
    key = ("a1k", 3, 4)
    assert gate.decide(key, 2, [16, 16], CPU) == "fuse"  # fused unmeasured
    assert REGISTRY.counter("batcher_fusion_prior_total",
                            kind="a1k").value == 1
    gate.observe_fused(key, 2, 1.0)  # the first sample is discarded
    gate.observe_fused(key, 2, 1.0)  # a fused launch far above 2 singles
    assert gate.decide(key, 2, [16, 16], CPU) == "standalone"
    calibrate.clear_policy()
    assert FusionCostModel(prior=_policy_prior).decide(
        key, 2, [16, 16], CPU) == "fuse"


def test_service_stats_surface_calibration():
    from repro.service import MiningService as RefService
    from repro_torch.service import MiningService
    stats = MiningService(device=CPU).stats()
    assert stats["calibration"]["source"] == "heuristic"
    assert "decisions" in stats["calibration"]
    assert sorted(stats["calibration"]) == \
        sorted(RefService().stats()["calibration"])


# --------------------------------------------- streaming against the reference

# A table under which the segment-parallel rows cost the same whichever
# engine name a caller scores (no analytic term): the reference's CPU
# counter scores "mapconcatenate", the port's "mapconcat_kernel" (K4's
# Map and fold, what its commits run). Fewer segments are cheaper, so
# the table changes every commit's q from the heuristic's.
_MAPC_ROW = [2e-4, 0.0, 1.5e-3, 0.0, 1e-5, 0.0]
STREAM_TRUE = {"ptpe": [1e-3, 0.0, 0.0, 0.0, 0.0, 0.0],
               "mapconcatenate": _MAPC_ROW, "mapconcat_kernel": _MAPC_ROW}


def _stream_table():
    return CalibrationTable(
        device_kind=calibrate.CPU_FINGERPRINT, hw=HW,
        coeffs={e: list(c) for e, c in STREAM_TRUE.items()},
        grid=[{"n_events": 4096}], segment_counts=[1, 4, 8])


def _record_q(monkeypatch, cls, log):
    orig = cls.choose_segments

    def spy(self, candidates, **kw):
        got = orig(self, candidates, **kw)
        log.append((kw["n_episode"], kw["m"], tuple(candidates), got))
        return got
    monkeypatch.setattr(cls, "choose_segments", spy)


def test_streaming_miner_with_table_matches_reference(ref_kernel_probe,
                                                      monkeypatch):
    """The same table installed in both packages: a ``hybrid`` miner's
    windows, engines per level and segment count per commit are equal;
    the table keeps the heuristic's engines here (it changes every q), so
    the windows also equal the heuristic's."""
    stream, _ = sym26(seconds=6, seed=3)
    ref_stream, _ = ref_sym26(seconds=6, seed=3)
    wins = list(partition_windows(stream, 2000))
    ref_wins = list(ref_windows(ref_stream, 2000))
    table = _stream_table()
    calibrate.set_policy(DispatchPolicy(table))
    ref_cal.set_policy(ref_cal.DispatchPolicy(
        ref_cal.CalibrationTable.from_doc(table.to_doc())))
    q_port, q_ref = [], []
    _record_q(monkeypatch, DispatchPolicy, q_port)
    _record_q(monkeypatch, ref_cal.DispatchPolicy, q_ref)
    kw = dict(max_level=3, mode="per_window", engine="hybrid")
    port = StreamingMiner([(5, 10)], 10, device=CPU, **kw)
    ref = RefMiner([(5, 10)], 10, **kw)
    heur = []
    for i, (w, rw) in enumerate(zip(wins, ref_wins)):
        final = i == len(wins) - 1
        res, want = port.update(w, final=final), ref.update(rw, final=final)
        assert len(res.frequent) == len(want.frequent)
        for fa, fb, ca, cb in zip(res.frequent, want.frequent, res.counts,
                                  want.counts):
            np.testing.assert_array_equal(fa.etypes, fb.etypes)
            np.testing.assert_array_equal(ca, cb)
        heur.append(res)

    def engines(miner):
        return sorted((f.eps.N, f.engine) for _, frags in
                      miner._exact.values() for f in frags)
    assert engines(port) == engines(ref)
    assert {e for _, e in engines(port)} == {"ptpe", "mapconcatenate"}
    assert q_port == q_ref and q_port
    assert {got for *_, got in q_port} == {(1, "calibrated")}
    # the heuristic's miner: the same engines, so the same windows
    calibrate.clear_policy()
    plain = StreamingMiner([(5, 10)], 10, device=CPU, **kw)
    for i, w in enumerate(wins):
        res = plain.update(w, final=i == len(wins) - 1)
        for ca, cb in zip(res.counts, heur[i].counts):
            np.testing.assert_array_equal(ca, cb)
    assert engines(plain) == engines(port)
    assert calibrate.policy_stats()["decisions"].get(
        "mapconcatenate/calibrated", 0) >= 1


# ------------------------------------------- measurement path (smoke)


def test_measure_fit_install_roundtrip(tmp_path):
    """A 2-point CPU grid: every engine the port runs is measured, too
    few points per engine drop it from the fit (its prediction honestly
    None), and the table saves, loads and installs for the host."""
    spec = GridSpec(episode_sizes=(2,), episode_counts=(4, 8),
                    event_counts=(64,), segment_counts=(1,),
                    repeats=1, warmup=1, num_types=5)
    assert len(spec.points()) == 2
    seen = []
    pts = calibrate.measure_grid(spec, progress=seen.append, device=CPU)
    assert {p["engine"] for p in pts} == {"ptpe", "mapconcatenate",
                                          "mapconcat_kernel"}
    assert len(seen) == len(pts) == 6
    assert all(p["seconds"] > 0 and p["devices"] == 1 for p in pts)
    table = fit_table(pts, HW, device=CPU)
    assert table.device_kind == "cpu:plain"
    assert table.predict("ptpe", n_episode=2, m=4, n_events=64) is None
    path = table.save(str(tmp_path / "t.json"))
    pol = install_table(path, device=CPU)
    assert pol.source == "calibrated" and pol.table.grid == pts
    # nothing fitted: every choice is still Eq. 2's
    assert pol.choose(n_events=64, n_episode=2, m=4,
                      device=CPU).source == "heuristic"


def test_calibrate_and_save_installs_and_caches(tmp_path):
    spec = GridSpec(episode_sizes=(2, 3), episode_counts=(4, 8, 16),
                    event_counts=(64, 128), segment_counts=(1, 2),
                    repeats=1, warmup=1, num_types=5)
    path = str(tmp_path / "cal" / "table.json")
    table, got_path = calibrate.calibrate_and_save(
        spec, hw=HW, out_path=path, device=CPU)
    assert got_path == path
    assert sorted(table.coeffs) == ["mapconcat_kernel", "mapconcatenate",
                                    "ptpe"]
    assert calibrate.get_policy().source == "calibrated"
    back = load_table(path)
    assert back is not None and back.coeffs == table.coeffs
    # the cached table steers a fresh process the same way
    calibrate.clear_policy()
    pol = install_table(path, device=CPU)
    assert pol.source == "calibrated"
    assert pol.choose(n_events=128, n_episode=3, m=8,
                      device=CPU).source == "calibrated"


def test_measure_hw_on_the_host():
    from repro_torch.launch.calibrate import fit_errors, measure_hw
    hw = measure_hw(CPU)
    assert hw["hbm_bw"] > 0 and hw["ici_bw"] == hw["hbm_bw"]
    errs = fit_errors(fit_table(synth_points(TRUE), hw, device_kind="k"))
    assert sorted(errs) == ["mapconcatenate", "ptpe"]
    assert all(np.isfinite(v) and v >= 0 for v in errs.values())


def test_calibrate_cli_smoke_on_the_host(tmp_path, monkeypatch, capsys):
    """``launch.calibrate --device cpu`` on a tiny grid: the table is
    cached under the data dir by fingerprint and dumped as JSON."""
    from repro_torch.launch import calibrate as cli
    monkeypatch.setattr(cli.GridSpec, "smoke", classmethod(
        lambda cls: cls(episode_sizes=(2, 3), episode_counts=(4, 8, 16),
                        event_counts=(64, 128), segment_counts=(1, 2),
                        repeats=1, num_types=5)))
    out = tmp_path / "doc.json"
    assert cli.main(["--smoke", "--device", "cpu", "--quiet", "--data-dir",
                     str(tmp_path / "cal"), "--json-out", str(out)]) == 0
    assert (tmp_path / "cal" / "cpu_plain.json").exists()
    doc = json.loads(out.read_text())
    assert doc["device_kind"] == "cpu:plain"
    assert set(doc["hw"]) == {"hbm_bw", "ici_bw"}
    assert ref_cal.CalibrationTable.from_doc(doc) is not None
    assert "relative fit error" in capsys.readouterr().out


def test_calibrate_module_imports_stay_stdlib():
    """The module-level import set stays stdlib (plus the port's stdlib
    observability plane): torch and numpy are lazy, jax and the reference
    absent."""
    import ast
    tree = ast.parse(open(calibrate.__file__).read())
    top = set()
    for node in tree.body:
        if isinstance(node, ast.Import):
            top |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            top.add((node.module or "").split(".")[0])
    assert not top & {"jax", "numpy", "torch", "repro"}
    assert top <= {"__future__", "dataclasses", "json", "os", "re",
                   "threading", "repro_torch"}


def _defined_names(module) -> set[str]:
    """Public names a module defines at top level (def, class, assign)."""
    import ast
    out = set()
    for node in ast.parse(open(module.__file__).read()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            for t in (node.targets if isinstance(node, ast.Assign)
                      else [node.target]):
                if isinstance(t, ast.Name):
                    out.add(t.id)
    return {n for n in out if not n.startswith("_")}


def test_public_names_match_reference():
    """Every public name of the reference's module exists in the port."""
    ref_names = _defined_names(ref_cal)
    assert {"GridSpec", "DispatchPolicy", "measure_grid", "fit_table",
            "calibrate_and_save", "FEATURE_NAMES"} <= ref_names
    missing = ref_names - set(vars(calibrate))
    assert not missing, missing
    assert len(FEATURE_NAMES) == 6


def test_daemon_takes_the_policy_table(tmp_path, monkeypatch):
    """``mine_serve --listen --policy-table`` hands the table to the
    daemon's config, whose service installs it; the daemon's own CLI
    parses the flag too."""
    from repro_torch.launch import mine_serve
    from repro_torch.service import daemon

    path = make_table(TRUE).save(str(tmp_path / "t.json"))
    seen = []
    monkeypatch.setattr(daemon.MiningDaemon, "run", lambda self: seen.append(
        (self.config, self.service.stats()["calibration"]["source"])))
    assert mine_serve.main(["--listen", "127.0.0.1:0", "--device", "cpu",
                            "--data-dir", str(tmp_path / "data"),
                            "--policy-table", path]) == 0
    assert seen[0][0].policy_table == path and seen[0][1] == "calibrated"
    got = []
    monkeypatch.setattr(daemon, "serve_foreground", got.append)
    daemon.main(["--policy-table", path, "--device", "cpu"])
    assert got[0].policy_table == path


# ------------------------------------------- the traffic probe (--hlo)


@pytest.fixture(scope="module")
def probes():
    """(port, reference) ``hlo_traffic_probe()`` at the default point."""
    from repro.launch import calibrate as ref_cli
    from repro_torch.launch import calibrate as cli
    return cli.hlo_traffic_probe(), ref_cli.hlo_traffic_probe()


def test_hlo_traffic_probe_matches_reference_keys(probes):
    """The reference's keys and point; traffic > 0 in both packages (the
    totals differ: XLA fuses the scan's body, the port counts eager ops);
    the counter has no contraction, so both read 0 FLOPs."""
    from repro_torch.launch.roofline import HBM_BW
    got, want = probes
    assert set(got) == set(want) == {"point", "traffic_bytes", "dot_flops",
                                     "hbm_implied_s"}
    assert got["point"] == want["point"] == {"n_episode": 3, "m": 64,
                                             "n_events": 1024, "lcap": 4}
    assert got["traffic_bytes"] > 0 and want["traffic_bytes"] > 0
    assert got["dot_flops"] == want["dot_flops"] == 0
    assert got["hbm_implied_s"] == got["traffic_bytes"] / HBM_BW


def test_roofline_hw_is_the_roofline_constants():
    from repro.launch import calibrate as ref_cli
    from repro_torch.launch import calibrate as cli
    from repro_torch.launch import roofline
    assert set(cli.ROOFLINE_HW) == set(ref_cli.ROOFLINE_HW)
    assert cli.ROOFLINE_HW == {"peak_flops": roofline.PEAK_FLOPS,
                               "hbm_bw": roofline.HBM_BW,
                               "ici_bw": roofline.ICI_BW}


def _tiny_smoke(monkeypatch, cli):
    """A 2-point smoke grid (too few points to fit an engine: the table
    still saves, with its meta)."""
    monkeypatch.setattr(cli.GridSpec, "smoke", classmethod(
        lambda cls: cls(episode_sizes=(2,), episode_counts=(4, 8),
                        event_counts=(64,), segment_counts=(1,),
                        repeats=1, warmup=1, num_types=5)))


def test_run_with_hlo_writes_meta(tmp_path, monkeypatch):
    """``run(..., hlo=True, device="cpu")`` on a tiny smoke grid: the
    saved table's ``meta["hlo"]`` is the probe's; the fit still seeds
    from the measured rates."""
    from repro_torch.launch import calibrate as cli
    _tiny_smoke(monkeypatch, cli)
    path = str(tmp_path / "t.json")
    table, got_path = cli.run(cli.GridSpec.smoke(), out_path=path,
                              data_dir=None, device="cpu", hlo=True,
                              quiet=True)
    assert got_path == path
    assert set(table.hw) == {"hbm_bw", "ici_bw"}
    assert table.meta["hlo"]["point"]["m"] == 64
    assert table.meta["hlo"]["traffic_bytes"] > 0
    assert load_table(path).meta["hlo"] == table.meta["hlo"]


def test_calibrate_cli_hlo_prints_cross_check(tmp_path, monkeypatch, capsys,
                                              probes):
    from repro_torch.launch import calibrate as cli
    _tiny_smoke(monkeypatch, cli)
    monkeypatch.setattr(cli, "hlo_traffic_probe", lambda: probes[0])
    out = tmp_path / "doc.json"
    assert cli.main(["--smoke", "--device", "cpu", "--hlo", "--quiet",
                     "--data-dir", str(tmp_path / "cal"), "--json-out",
                     str(out)]) == 0
    assert json.loads(out.read_text())["meta"]["hlo"] == probes[0]
    text = capsys.readouterr().out
    assert "[calibrate] HLO cross-check: " in text
    assert "us HBM-implied at the probe point" in text
