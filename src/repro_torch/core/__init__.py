"""Frequent-episode mining engine — the paper's contribution, PyTorch port
of ``repro.core``.

Public API:
  EventStream, EpisodeBatch — data containers
  count_a1 / count_a2       — exact / relaxed-upper-bound counting
  count_two_pass            — Algorithm 4 (A2 cull → A1 exact)
  count_dispatch            — Hybrid dispatcher (Algorithm 2 / Eq. 2)
  mapconcatenate(_kernel)   — segment-parallel MapConcatenate (§5.2.2)
  mapconcatenate_sharded(_kernel), stream_mesh — its multi-device form
  mine / mine_partitions    — level-wise miner, streaming windows
  count_windows             — the WINEPI window-count baseline
  reconstruct               — functional connectivity from mined episodes
"""

from .candidates import join_next_level, level1, level2
from .count_a1 import A1State, count_a1, count_a1_vectorized, init_a1_state
from .count_a2 import A2State, count_a2, count_single_slot, init_a2_state
from .episodes import EpisodeBatch
from .events import (PAD_TYPE, TIME_NEG_INF, EventStream, count_level1,
                     type_histogram)
from .calibrate import DispatchChoice, DispatchPolicy, get_policy
from .hybrid import count_dispatch, crossover, f_of_n
from .mapconcat import (concatenate_tree, data_mesh, fold_pair,
                        fold_pair_unrolled, make_segments, mapconcatenate,
                        mapconcatenate_kernel, mapconcatenate_sharded,
                        mapconcatenate_sharded_kernel, phase_cum,
                        shard_device_count, stitch_zones, stream_mesh)
from .miner import LevelStats, MiningResult, mine, mine_partitions
from .connectivity import ConnectivityGraph, reconstruct
from .ref import (count_a1_sequential, count_a2_sequential,
                  count_occurrences_naive)
from .streaming import (StagedWindow, StreamingA2Counter, StreamingCounter,
                        StreamingMiner, bucket_size)
from .twopass import (TwoPassResult, TwoPassState, count_one_pass,
                      count_two_pass)
from .windows import count_windows, frequency_windows

__all__ = [
    "EventStream", "EpisodeBatch", "PAD_TYPE", "TIME_NEG_INF",
    "type_histogram", "count_level1",
    "count_a1", "count_a1_vectorized", "count_a2", "count_single_slot",
    "A1State", "A2State", "init_a1_state", "init_a2_state",
    "count_two_pass", "count_one_pass", "TwoPassResult", "TwoPassState",
    "count_dispatch", "crossover", "f_of_n",
    "DispatchChoice", "DispatchPolicy", "get_policy",
    "mapconcatenate", "mapconcatenate_kernel", "make_segments",
    "mapconcatenate_sharded", "mapconcatenate_sharded_kernel",
    "data_mesh", "shard_device_count", "stream_mesh",
    "fold_pair", "fold_pair_unrolled", "concatenate_tree", "phase_cum",
    "stitch_zones",
    "mine", "mine_partitions", "MiningResult", "LevelStats",
    "StreamingCounter", "StreamingA2Counter", "StreamingMiner",
    "StagedWindow", "bucket_size",
    "level1", "level2", "join_next_level",
    "count_a1_sequential", "count_a2_sequential", "count_occurrences_naive",
    "count_windows", "frequency_windows", "reconstruct",
    "ConnectivityGraph",
]
