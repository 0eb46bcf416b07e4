"""The port's multi-tenant service against the reference's with
unbounded history (``history_limit=None``): for every engine × two-pass
combination the port's per-session deltas equal the reference
``MiningService``'s and a standalone port ``StreamingMiner``'s, window by
window (the case itself is ``test_torch_service.service_matrix_case``).
Tolerance: exact equality of every integer.
"""

import pytest
import torch

from test_torch_service import ENGINES, service_matrix_case

# The plain versions step small tensors, one event at a time: intra-op
# threads only contend with the other test processes.
torch.set_num_threads(1)


@pytest.fixture
def ref_kernel_probe(monkeypatch):
    """Pin the reference's segmented-kernel probe on, so that its ``hybrid``
    resolves as one device with the kernel does (the port's rule)."""
    import repro.core.hybrid as ref_hybrid
    monkeypatch.setattr(ref_hybrid, "_mapc_kernel_available", lambda: True)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("two_pass", [True, False])
def test_unbounded_service_equals_reference_and_standalone(
        ref_kernel_probe, engine, two_pass):
    service_matrix_case(engine, two_pass, None)
