"""A 2-session ``MiningService`` outside the CUDA templates' envelope
(LCAP 3 and 5, ``max_level`` 10) on the CPU, on streams with a planted
10-node chain (``test_torch_envelope.chain_windows``), against the
reference's service and against standalone port miners, bit for bit."""

import pytest
import torch

from repro.service import MiningService as RefService
from repro.service import SessionConfig as RefConfig
from repro_torch.service import MiningService, SessionConfig
from test_torch_envelope import CPU, assert_same, chain_windows

# The plain versions step small tensors, one event at a time: intra-op
# threads only contend with the other test processes.
torch.set_num_threads(1)


@pytest.fixture
def ref_kernel_probe(monkeypatch):
    """Pin the reference's segmented-kernel probe on, so that its ``hybrid``
    resolves as one device with the kernel does (the port's rule)."""
    import repro.core.hybrid as ref_hybrid
    monkeypatch.setattr(ref_hybrid, "_mapc_kernel_available", lambda: True)


@pytest.mark.parametrize("lcap", [3, 5])
def test_service_outside_envelope_equals_reference(ref_kernel_probe, lcap):
    kw = dict(intervals=((5, 10),), theta=8, max_level=10, lcap=lcap,
              engine="hybrid", two_pass=True, history_limit=4)
    port, ref = MiningService(device=CPU), RefService()
    tenants = []
    for q in range(2):
        wins, ref_wins = chain_windows(seconds=2, seed=q)
        port.create_session(f"s{q}", SessionConfig(**kw))
        ref.create_session(f"s{q}", RefConfig(**kw))
        for j, (w, rw) in enumerate(zip(wins, ref_wins)):
            final = j == len(wins) - 1
            port.ingest(f"s{q}", w, final=final)
            ref.ingest(f"s{q}", rw, final=final)
        tenants.append((f"s{q}", wins))
    port.pump()
    ref.pump()
    for sid, wins in tenants:
        got, want = port.poll(sid), ref.poll(sid)
        assert [d.window_idx for d in got] == list(range(len(wins)))
        alone = SessionConfig(**kw).make_miner(device=CPU)
        for j, (d, r, w) in enumerate(zip(got, want, wins)):
            assert_same(d.result, r.result)
            assert_same(d.result, alone.update(w, final=j == len(wins) - 1))
    assert port.batcher.batches > 0
