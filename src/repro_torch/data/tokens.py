"""Token pipeline for LM training (port of ``repro.data.tokens``):
deterministic synthetic corpora (so loss curves are reproducible) with a
next-token objective. The batches are the reference's bit for bit (the
same numpy generators), as tensors on the caller's device, keyed as
``models.loss_fn`` expects."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig


def synthetic_lm_batches(cfg: ModelConfig, batch: int, seq: int,
                         seed: int = 0, start: int = 0, device=None):
    """Infinite iterator of learnable synthetic LM batches: a noisy
    order-1 Markov chain over the vocab (so CE can drop well below
    log-uniform). ``tokens``/``labels`` int32 [batch, seq], or for the
    stub-frontend archs float32 ``embeddings`` [batch, seq, d_model] in
    place of ``tokens``; batch i of the stream comes from seed (seed, i),
    so ``start`` resumes it. ``device`` defaults to the CUDA card."""
    vocab = cfg.vocab_size
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    # random sparse transition table: each symbol prefers 4 successors
    succ = rng.integers(0, vocab, size=(vocab, 4))
    i = start
    while True:
        brng = np.random.default_rng((seed, i))
        toks = np.empty((batch, seq + 1), np.int32)
        toks[:, 0] = brng.integers(0, vocab, size=batch)
        for t in range(seq):
            pick = brng.integers(0, 4, size=batch)
            nxt = succ[toks[:, t], pick]
            noise = brng.random(batch) < 0.1
            nxt = np.where(noise, brng.integers(0, vocab, size=batch), nxt)
            toks[:, t + 1] = nxt
        out = {"labels": torch.from_numpy(toks[:, 1:].copy()).to(dev)}
        if cfg.stub_frontend:
            erng = np.random.default_rng((seed + 1, i))
            # frame/patch embeddings stand-in derived from the token ids
            emb = erng.standard_normal((vocab, cfg.d_model)).astype(
                np.float32) * 0.02
            out["embeddings"] = torch.from_numpy(emb[toks[:, :-1]]).to(dev)
        else:
            out["tokens"] = torch.from_numpy(toks[:, :-1].copy()).to(dev)
        yield out
        i += 1
