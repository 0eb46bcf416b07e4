"""End-to-end training example (port of ``examples/train_lm.py``): a ~20M-
parameter gemma-family model, a few hundred steps, with checkpoint/restart
and the watchdog (kill it mid-run and re-launch: it resumes from the last
complete checkpoint).

  PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 200] \\
      [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

from repro_torch.configs import get_smoke_config
from repro_torch.launch.train import train_loop


def mini_config():
    cfg = get_smoke_config("gemma3_1b")
    return dataclasses.replace(cfg, d_model=256, num_heads=8, head_dim=32,
                               d_ff=1024, num_layers=8, vocab_size=2048,
                               name="gemma3-mini-20m")


def run(steps: int = 200, ckpt_dir: str | None = None,
        device=None) -> list[float]:
    """Train ``mini_config()`` at batch 8 × seq 64 (checkpoints every 50
    steps under ``ckpt_dir``) and assert the loss fell; returns the
    losses."""
    cfg = mini_config()
    print(f"{cfg.name}: {cfg.num_params()/1e6:.1f}M params")
    if ckpt_dir is None:
        ckpt_dir = os.path.join(tempfile.gettempdir(), "repro_train_lm")
    _, _, losses = train_loop(cfg, steps=steps, batch=8, seq=64,
                              ckpt_dir=ckpt_dir, ckpt_every=50,
                              log_every=20, device=device)
    print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"({'improved' if losses[-1] < losses[0] else 'NOT improved'})")
    assert losses[-1] < losses[0]
    return losses


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: repro_train_lm "
                         "under the temporary directory)")
    ap.add_argument("--device", default=None,
                    help="where the model trains (default: the CUDA card)")
    args = ap.parse_args(argv)
    run(args.steps, args.ckpt_dir, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
