"""Quickstart: mine frequent episodes from a synthetic spike train (port of
``examples/quickstart.py``). The counting kernels run on ``--device``
(default: the CUDA card; ``cpu`` runs their plain PyTorch versions).

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

from repro_torch.core import count_a1_sequential, mine, reconstruct
from repro_torch.data import sym26


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="where the counting kernels run (default: the "
                         "CUDA card; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)

    # 1. A 26-neuron culture, 20 s, with two planted causal chains.
    stream, truth = sym26(seconds=20, seed=0)
    chain, interval, n_planted = truth["short"]
    print(f"{len(stream)} events; planted chain {chain} "
          f"with delays in {interval}, ~{n_planted} occurrences")

    # 2. Mine all episodes up to 3 nodes with the two-pass engine
    #    (A2 upper-bound cull -> exact A1, Hybrid PTPE/MapConcatenate
    #    mapping).
    result = mine(stream, intervals=[interval], theta=int(n_planted * 0.6),
                  max_level=3, device=args.device)
    for stats in result.stats:
        print(f"  level {stats.level}: {stats.num_candidates} candidates "
              f"-> {stats.num_survived_a2} after A2 cull "
              f"-> {stats.num_frequent} frequent  "
              f"({stats.seconds * 1e3:.0f} ms)")

    # 3. The planted chain is recovered, with an exactly-correct count.
    lv3 = result.frequent[2]
    found = [tuple(e) for e in lv3.etypes.tolist()]
    idx = found.index(tuple(chain))
    exact = count_a1_sequential(stream, lv3.select([idx]))[0]
    print(f"recovered {chain}: count={result.counts[2][idx]} "
          f"(sequential oracle: {exact})")
    if result.counts[2][idx] != exact:
        raise AssertionError(
            f"count {result.counts[2][idx]} != sequential oracle {exact}")

    # 4. Reconstruct the circuit (the paper's Fig. 1 end goal): the planted
    #    synapses dominate the excess-co-firing graph.
    g = reconstruct(stream, result)
    print("strongest inferred connections:")
    for a, b, w, c in g.top_edges(4):
        print(f"  neuron {a} → neuron {b}   weight {w:.3f}  (count {c})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
