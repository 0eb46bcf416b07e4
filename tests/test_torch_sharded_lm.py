"""The sharded LM steps on a real 2×2 mesh: 4 CPU ranks over gloo
(``tests/torch_sharded_ranks.py``, one subprocess that starts the ranks,
rendezvous through a ``FileStore`` under ``tmp_path``, its own timeout).
For the smoke configs of gemma3_1b (dense), moonshot_v1_16b_a3b (MoE) and
falcon_mamba_7b (SSM), in float32, against the port's one-device steps on
the same weights and batches: loss, ce, aux and gnorm within 1e-5
relative, the updated parameters, the moments and the gathered gradients
within 1e-4 relative L2, prefill logits and the spliced caches within
1e-5, decode logits within 1e-5 and greedy tokens identical, and
``serve_batch(mesh=...)``'s tokens equal to ``serve_batch``'s. gemma3's
weights are carried into the reference and its sharded steps land within
1e-4 relative L2 of the reference's own ``make_train_step`` on one
device. Nothing of ``torch.distributed`` runs in the pytest process."""

import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch_walk_cases  # noqa: F401  (puts the repository root on the path)
import torch_sharded_ranks as ranks
from test_torch_train_grads import rel_l2

from repro.configs import get_smoke_config as ref_smoke
from repro.data.tokens import synthetic_lm_batches as ref_batches
from repro.launch import steps as ref_steps
from repro.optim import adamw_init as ref_adamw_init
from repro_torch import models as P
from repro_torch.configs import get_smoke_config

TIMEOUT = 170


def test_sharded_train_prefill_decode_on_a_2x2_gloo_mesh(tmp_path):
    env = dict(os.environ, RANKS_TIMEOUT=str(TIMEOUT - 10))
    run = subprocess.Popen(
        [sys.executable, ranks.__file__, str(tmp_path)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        # the reference's steps run on gemma3's weights while the ranks do
        init = tmp_path / "gemma3_1b_init.npz"
        deadline = time.monotonic() + TIMEOUT
        while not init.exists() and run.poll() is None \
                and time.monotonic() < deadline:
            time.sleep(0.1)
        ref_cfg, cfg = ref_smoke("gemma3_1b"), get_smoke_config("gemma3_1b")
        want = None
        if init.exists():
            with np.load(init) as z:
                params = jax.tree.map(jnp.asarray,
                                      P.stack_params(dict(z), cfg))
            opt = ref_adamw_init(params,
                                 moment_dtype=jnp.dtype(cfg.moment_dtype))
            step = jax.jit(ref_steps.make_train_step(ref_cfg,
                                                     **ranks.STEP_KW))
            batches = ref_batches(ref_cfg, ranks.BATCH, ranks.SEQ, seed=3)
            for _ in range(ranks.STEPS):
                params, opt, _ = step(params, opt, next(batches))
            want = P.unstack_params(jax.tree.map(np.asarray, params), cfg)
        out, _ = run.communicate(timeout=max(deadline - time.monotonic(), 1))
    finally:
        if run.poll() is None:
            run.kill()
            run.wait()
    logs = "\n".join((tmp_path / f"rank{r}.log").read_text()[-3000:]
                     for r in range(ranks.WORLD)
                     if (tmp_path / f"rank{r}.log").exists())
    assert run.returncode == 0, out + logs
    res = json.loads((tmp_path / "results.json").read_text())
    assert res["mesh"] == {"data": 2, "model": 2}
    for arch in ranks.ARCHS:
        tr, sv = res[arch]["train"], res[arch]["serve"]
        for k in ("loss", "ce", "aux", "gnorm", "lr"):
            assert tr[f"metric_{k}"] <= 1e-5, (arch, k, tr)
        assert tr["update"] > 1e-3  # the step moved the weights
        assert tr["step"] == ranks.STEPS and tr["sharded_params"] > 0
        for k in ("params", "grads", "moments"):
            assert tr[k] <= 1e-4, (arch, k, tr)
        for k in ("prefill_logits", "decode_caches", "decode_logits"):
            assert sv[k] <= 1e-5, (arch, k, sv)
        assert sv["decode_tokens_equal"], (arch, sv)
        # decode shards the cache's sequence (or the mamba state's din)
        # over "model", and the step keeps it so
        assert sv["decode_cache_placements"] == ["S(0)", "S(1)"], sv
    assert res["falcon_mamba_7b"]["serve"]["serve_tokens_equal"]
    assert want is not None
    with np.load(tmp_path / "gemma3_1b_after.npz") as got:
        errs = {n: rel_l2(got[n], want[n]) for n in want}
    assert max(errs.values()) <= 1e-4, sorted(
        errs.items(), key=lambda kv: -kv[1])[:5]
