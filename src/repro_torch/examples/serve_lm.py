"""Batched serving example (port of ``examples/serve_lm.py``): prefill a
batch of prompts through the attention-free falcon-mamba family (O(1)-state
decode) and generate tokens.

  PYTHONPATH=src python -m repro_torch.examples.serve_lm [--device cpu]
"""

from __future__ import annotations

import argparse

from repro_torch.configs import get_smoke_config
from repro_torch.launch.serve import serve_batch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="where the model runs (default: the CUDA card)")
    args = ap.parse_args(argv)
    cfg = get_smoke_config("falcon_mamba_7b")
    toks, stats = serve_batch(cfg, batch=4, prompt_len=32, gen=16,
                              device=args.device)
    print(f"generated token grid {tuple(toks.shape)}")
    print(f"prefill {stats['prefill_s'] * 1e3:.0f} ms, "
          f"decode {stats['tok_per_s']:.1f} tok/s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
