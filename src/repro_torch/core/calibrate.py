"""Dispatch policy — engine and segment-count choice, PyTorch port of the
policy half of ``repro.core.calibrate``, heuristic only.

``DispatchPolicy`` is the one consult point for ``hybrid.count_dispatch``
(one-shot) and ``StreamingCounter`` (streaming): it applies the paper's
Eq. 2 rule as ``hybrid`` spells it, and keeps the caller's first segment
count. Results are bit-identical whichever engine it picks; only wall
clock rides on it.

The reference's measured cost tables (``measure_grid``, ``fit_table``,
``CalibrationTable``, ``set_policy``) belong to the calibration slice of
the port. Until then a table asked for through ``REPRO_POLICY_TABLE`` or
``REPRO_CALIBRATION_DIR`` raises instead of being ignored.
"""

from __future__ import annotations

import dataclasses
import os

ENV_TABLE = "REPRO_POLICY_TABLE"
ENV_TABLE_DIR = "REPRO_CALIBRATION_DIR"


@dataclasses.dataclass(frozen=True)
class DispatchChoice:
    engine: str
    num_segments: int
    source: str                    # "heuristic" (the only source so far)


class DispatchPolicy:
    """Engine/segment-count selection by the Eq. 2 heuristic."""

    # ------------------------------------------------------ one-shot path

    def choose(self, *, n_events: int, n_episode: int, m: int,
               shard_devices: int = 1, default_segments: int = 8,
               device=None) -> DispatchChoice:
        """Engine + segment count for one ``count_dispatch`` call;
        ``shard_devices`` is the mesh width the segment axis can shard
        over (``hybrid.shard_devices``), ``device`` the caller's (the
        capacity term of ``hybrid.crossover``)."""
        return self._heuristic_choice(n_events=n_events, n_episode=n_episode,
                                      m=m, shard_devices=shard_devices,
                                      default_segments=default_segments,
                                      device=device)

    def _heuristic_choice(self, *, n_events, n_episode, m, shard_devices,
                          default_segments, device) -> DispatchChoice:
        """Eq. 2 (see ``hybrid``): PTPE above the capacity-scaled
        crossover, the segmented kernel — sharded over the mesh when it
        holds more than one device — where the stream is long and the
        batch cannot fill a tile of episodes."""
        from . import hybrid
        mapc_kernel = (hybrid._mapc_kernel_available()
                       and n_events >= hybrid.MAPC_KERNEL_MIN_EVENTS)
        kern = ("mapconcat_sharded" if shard_devices > 1
                else "mapconcat_kernel")
        if m > hybrid.crossover(n_episode, device):
            if mapc_kernel and m <= hybrid.MAPC_KERNEL_MAX_EPISODES:
                engine = kern
            else:
                engine = "ptpe"
        elif mapc_kernel:
            engine = kern
        else:
            engine = "mapconcatenate"
        return DispatchChoice(engine, default_segments, "heuristic")

    # ----------------------------------------------------- streaming path

    def choose_stream(self, *, n_episode: int, m: int,
                      shard_devices: int = 1,
                      device=None) -> DispatchChoice:
        """Resolve a streaming counter's ``hybrid`` to ptpe or the
        segment-parallel engine (whose commits ``StreamingCounter`` shards
        itself when the mesh is wider than one device). ``shard_devices``
        is kept in the signature as in the reference: only a calibration
        table reads it."""
        return self._stream_heuristic(n_episode, m, device)

    def _stream_heuristic(self, n_episode: int, m: int,
                          device=None) -> DispatchChoice:
        from . import hybrid
        engine = ("ptpe" if m > hybrid.crossover(n_episode, device)
                  else "mapconcatenate")
        return DispatchChoice(engine, 0, "heuristic")

    def choose_segments(self, candidates: list[int], *,
                        devices: int = 1) -> int:
        """Pick a segment count from the caller's *safety-filtered*
        candidate list (stitch bounds stay the caller's job): the caller's
        first preference. ``devices`` (the mesh width the commit shards
        over) is kept as in the reference: only a calibration table reads
        it."""
        if not candidates:
            raise ValueError("empty segment candidate list")
        return candidates[0]


_POLICY = DispatchPolicy()


def get_policy() -> DispatchPolicy:
    """The process-global policy: the heuristic. A calibration table asked
    for through the environment raises, since tables are not ported."""
    for var in (ENV_TABLE, ENV_TABLE_DIR):
        if os.environ.get(var):
            raise NotImplementedError(
                f"{var} is set, but calibrated dispatch tables belong to "
                "the calibration slice of the PyTorch port (ROADMAP queue 1 "
                "item 10), which is not ported yet; unset it to use the "
                "Eq. 2 heuristic")
    return _POLICY
