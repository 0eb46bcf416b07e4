"""The routing bridge and chip-on-chip part 1 of the port against the
reference on the CPU: ``routing_events``/``decode_expert_episode`` bit for
bit; the example's MoE (the reference's weights carried across) routes the
motif corpus to the same top-k experts as the reference's, and the port's
``mine`` over that stream equals ``repro.core.mine`` level by level."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mine as ref_mine
from repro.models import init_params as ref_init_params
from repro.models.layers import rms_norm as ref_rms_norm
from repro.telemetry import decode_expert_episode as ref_decode
from repro.telemetry import routing_events as ref_routing_events
from repro_torch.core import mine
from repro_torch.examples import chip_on_chip as coc
from repro_torch.kernels import tally
from repro_torch.models import params_from_numpy
from repro_torch.telemetry import decode_expert_episode, routing_events

torch.set_num_threads(2)


@pytest.mark.parametrize("layers,ticks", [(None, 1), ([0, 2], 3),
                                          ([3, 1], 2)])
def test_routing_events_bit_equal(layers, ticks):
    topk = np.random.default_rng(1).integers(0, 16, (4, 60, 3)).astype(
        np.int32)
    got = routing_events(topk, 16, layers=layers, ticks_per_token=ticks)
    want = ref_routing_events(topk, 16, layers=layers,
                              ticks_per_token=ticks)
    for f in ("types", "times"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        assert getattr(got, f).dtype == getattr(want, f).dtype
    assert got.num_types == want.num_types
    for t in range(got.num_types):
        assert decode_expert_episode(t, 16) == ref_decode(t, 16)


def _ref_capture_routing(params, cfg, tokens):
    """The reference example's ``capture_routing`` (a script there)."""
    x = params["embed"][tokens].astype(jnp.bfloat16)
    out = []
    for j in range(cfg.period):
        stacked = params["blocks"]["scan"][j]
        for r in range(cfg.num_periods):
            p = jax.tree.map(lambda a: a[r], stacked)
            h = ref_rms_norm(x, p["ln2"])
            logits = h.astype(jnp.float32) @ p["moe"]["router"]
            _, topi = jax.lax.top_k(jax.nn.softmax(logits, -1), cfg.top_k)
            out.append(topi[0])
    return np.asarray(jnp.stack(out))


def _same_result(got, want):
    assert len(got.frequent) == len(want.frequent)
    for g, w, gc, wc in zip(got.frequent, want.frequent, got.counts,
                            want.counts):
        for f in ("etypes", "tlo", "thi"):
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f))
        np.testing.assert_array_equal(np.asarray(gc), np.asarray(wc))


@pytest.mark.parametrize("t", [512, 256])
def test_chip_on_chip_part1_matches_reference(t):
    cfg = coc.telemetry_config()
    params = ref_init_params(jax.random.PRNGKey(0), cfg)
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                              device="cpu")
    toks = coc.motif_tokens(t, cfg.vocab_size)
    topk = coc.capture_routing(model, toks[None, :])
    want_topk = _ref_capture_routing(params, cfg,
                                     jnp.asarray(toks[None, :], jnp.int32))
    np.testing.assert_array_equal(topk, want_topk)
    stream = routing_events(topk, cfg.num_experts)
    tally.reset_counts()
    res = coc.mine_routing(stream, t, device="cpu", engine="ptpe")
    # K1/K2's plain versions counted it
    plain = tally.plain_counts()
    assert plain.get("a2_count_state", 0) > 0
    assert plain.get("a1_count_state", 0) > 0
    want = ref_mine(ref_routing_events(want_topk, cfg.num_experts),
                    intervals=[(0, 3)], theta=int(t * 0.06), max_level=3,
                    engine="ptpe")
    _same_result(res, want)
    assert coc.top_cascades(res, cfg.num_experts)
    # the example's own default engine agrees too
    _same_result(mine(stream, [(0, 3)], int(t * 0.06), max_level=3,
                      device="cpu"), want)


def test_chip_on_chip_routing_part_runs_on_cpu(capsys):
    topk, res = coc.routing_part("cpu")
    assert topk.shape == (2, coc.ROUTING_T, 2)
    assert res.frequent[1].M > 0
    assert "top expert cascades" in capsys.readouterr().out
