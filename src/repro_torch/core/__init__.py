"""Frequent-episode mining engine — the paper's contribution, PyTorch port
of ``repro.core`` (episode-parallel engines so far).

Public API:
  EventStream, EpisodeBatch — data containers
  count_a1 / count_a2       — exact / relaxed-upper-bound counting
  count_two_pass            — Algorithm 4 (A2 cull → A1 exact)
  mine / mine_partitions    — level-wise miner, streaming windows
"""

from .candidates import join_next_level, level1, level2
from .count_a1 import A1State, count_a1, count_a1_vectorized, init_a1_state
from .count_a2 import A2State, count_a2, count_single_slot, init_a2_state
from .episodes import EpisodeBatch
from .events import (PAD_TYPE, TIME_NEG_INF, EventStream, count_level1,
                     type_histogram)
from .hybrid import count_dispatch
from .miner import LevelStats, MiningResult, mine, mine_partitions
from .ref import (count_a1_sequential, count_a2_sequential,
                  count_occurrences_naive)
from .streaming import (StagedWindow, StreamingA2Counter, StreamingCounter,
                        StreamingMiner, bucket_size)
from .twopass import (TwoPassResult, TwoPassState, count_one_pass,
                      count_two_pass)

__all__ = [
    "EventStream", "EpisodeBatch", "PAD_TYPE", "TIME_NEG_INF",
    "type_histogram", "count_level1",
    "count_a1", "count_a1_vectorized", "count_a2", "count_single_slot",
    "A1State", "A2State", "init_a1_state", "init_a2_state",
    "count_two_pass", "count_one_pass", "TwoPassResult", "TwoPassState",
    "count_dispatch",
    "mine", "mine_partitions", "MiningResult", "LevelStats",
    "StreamingCounter", "StreamingA2Counter", "StreamingMiner",
    "StagedWindow", "bucket_size",
    "level1", "level2", "join_next_level",
    "count_a1_sequential", "count_a2_sequential", "count_occurrences_naive",
]
