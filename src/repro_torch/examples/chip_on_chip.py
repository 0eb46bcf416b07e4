"""Chip-on-chip (port of ``examples/chip_on_chip.py``): one compute graph
(an MoE LM) emits routing events; the paper's mining engine consumes them.

Part 1 — the bridge: run a reduced MoE model over a corpus with an
artificial regularity (a repeating token motif), capture each layer's
top-k expert choices as an event stream (``repro_torch.telemetry``), and
mine frequent expert-routing episodes — "expert A at layer 0, then expert
B at layer 1 within 3 tokens" — the artificial-brain analogue of the
paper's syn-fire chains. The model and the counting kernels (K1/K2 behind
``mine``) run on ``--device``.

Part 2 — the service: two synthetic MEA sessions (different firing
statistics, different partition windows) stream through the multi-tenant
mining service concurrently, and each tenant's per-window frequent-episode
deltas are printed as they complete.

  PYTHONPATH=src python -m repro_torch.examples.chip_on_chip [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import mine
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.models.layers import rms_norm
from repro_torch.obs import TRACER, span
from repro_torch.telemetry import decode_expert_episode, routing_events

MOTIF = (7, 11, 13)        # tokens repeated every MOTIF_EVERY positions
MOTIF_EVERY = 16
INTERVALS = [(0, 3)]       # within-3-token chains, simultaneity included
THETA_SHARE = 0.06         # θ = int(THETA_SHARE · T)
MAX_LEVEL = 3
ROUTING_T = 512            # tokens of the motif corpus


def _span_s(name: str) -> float:
    """Wall seconds of the most recent completed span called ``name``."""
    return next(e.dur for e in reversed(TRACER.events()) if e.name == name)


def telemetry_config():
    """A small MoE: the dbrx smoke config at 2 layers, 8 experts, top 2."""
    return dataclasses.replace(get_smoke_config("dbrx_132b"), num_layers=2,
                               num_experts=8, top_k=2, name="moe-telemetry")


def motif_tokens(t: int, vocab_size: int, seed: int = 0) -> np.ndarray:
    """T random tokens with ``MOTIF`` planted at every ``MOTIF_EVERY``-th
    position."""
    toks = np.random.default_rng(seed).integers(0, vocab_size, size=t)
    for i, tok in enumerate(MOTIF):
        toks[i::MOTIF_EVERY] = tok
    return toks


@torch.no_grad()
def capture_routing(model, tokens) -> np.ndarray:
    """Forward the embedding (bfloat16, as the reference's) through each
    MoE block's ``ln2`` and router; returns the top-k expert ids
    int[L, T, K] of the first sequence, period position by position
    (the reference's order)."""
    cfg = model.cfg
    tokens = torch.as_tensor(tokens, device=model.embed.device)
    x = model.embed[tokens.long()].to(torch.bfloat16)
    out = []
    for j in range(cfg.period):
        for r in range(cfg.num_periods):
            block = model.blocks[r * cfg.period + j]
            _, _, topi = block.moe.route(rms_norm(x, block.ln2))
            out.append(topi[0])
    return torch.stack(out).cpu().numpy()


def mine_routing(stream, t: int, device=None, engine: str = "hybrid"):
    """``mine`` with the example's settings: intervals (0, 3], θ =
    int(0.06 T), three levels, two-pass."""
    return mine(stream, intervals=INTERVALS, theta=int(t * THETA_SHARE),
                max_level=MAX_LEVEL, engine=engine, device=device)


def top_cascades(res, num_experts: int, n: int = 5):
    """The deepest non-empty level's n most frequent episodes as
    ("L<layer>e<expert> → ...", count), most frequent first."""
    lvl = len(res.frequent) - 1 if res.frequent[-1].M \
        else len(res.frequent) - 2
    lv, counts = res.frequent[lvl], res.counts[lvl]
    out = []
    for i in np.argsort(-counts)[:n]:
        path = " → ".join(
            "L{}e{}".format(*decode_expert_episode(int(t), num_experts))
            for t in lv.etypes[i])
        out.append((path, int(counts[i])))
    return out


def routing_part(device):
    """Part 1 on ``device``: returns (routing int[L, T, K], result)."""
    t = ROUTING_T
    cfg = telemetry_config()
    model = init_params(cfg, 0, device)
    toks = motif_tokens(t, cfg.vocab_size)
    with span("example.capture_routing"):
        topk = capture_routing(model, toks[None, :])
        stream = routing_events(topk, cfg.num_experts, ticks_per_token=1)
    print(f"captured {len(stream)} routing events over {t} tokens "
          f"({topk.shape[0]} layers × top-{cfg.top_k}) "
          f"in {_span_s('example.capture_routing'):.2f}s")
    with span("example.mine_routing"):
        res = mine_routing(stream, t, device=device)
    print("top expert cascades (layer.expert → ...):")
    shown = top_cascades(res, cfg.num_experts)
    for path, cnt in shown:
        print(f"  {path}   ×{cnt}")
    assert shown, "no frequent expert cascade"
    print(f"mined in {_span_s('example.mine_routing'):.2f}s")
    return topk, res


def service_part(device) -> dict:
    """Part 2 on ``device``: two MEA sessions through the mining service;
    returns its ``stats()``."""
    from repro_torch.data import partition_windows, sym26
    from repro_torch.service import MiningService, SessionConfig

    print("\nmulti-tenant service: two MEA sessions, different windows")
    svc = MiningService(device=device)
    tenants = {}
    for sid, seed, rate, window_ms in (("culture-a", 0, 20.0, 1000),
                                       ("culture-b", 1, 35.0, 2500)):
        stream, truth = sym26(seconds=6, rate_hz=rate, seed=seed)
        svc.create_session(sid, SessionConfig(
            intervals=((5, 10),), theta=3, max_level=3,
            window_ms=window_ms, history_limit=4))
        wins = list(partition_windows(stream, window_ms))
        tenants[sid] = wins
        print(f"  {sid}: {len(stream)} events at {rate:.0f} Hz, "
              f"{len(wins)} windows of {window_ms} ms "
              f"(planted chain {truth['short'][0]})")

    # interleaved ingest — both cultures are mined concurrently
    with span("example.serve"):
        for j in range(max(len(w) for w in tenants.values())):
            for sid, wins in tenants.items():
                if j < len(wins):
                    svc.ingest(sid, wins[j], final=j == len(wins) - 1)
            svc.pump()
            for sid in tenants:
                for d in svc.poll(sid):
                    top = sorted(d.episodes(level=3),
                                 key=lambda ec: -ec[1])[:2]
                    print(f"  {sid} window {d.window_idx}: "
                          f"{d.n_events} events, top 3-episodes {top}")

    stats = svc.stats()
    for sid in tenants:
        s = stats["sessions"][sid]
        print(f"  {sid}: {s['events_per_sec']:,.0f} ev/s sustained, "
              f"p99 window latency {s['p99_latency_s'] * 1e3:.0f} ms")
    print(f"  batcher fused {stats['batcher']['fused_requests']} scans "
          f"into {stats['batcher']['batches']} device batches over "
          f"{_span_s('example.serve'):.2f}s; kernel launches "
          f"{stats['kernel']['launches']}")
    assert all(svc.session(sid).windows_done == len(w)
               for sid, w in tenants.items())
    return stats


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="where the model and the counting kernels run "
                         "(default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    routing_part(device)
    service_part(device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
