"""Assigned input-shape cells (port of ``repro.launch.shapes``) and their
input shapes as ``meta`` tensors (shape and dtype, no memory).

``long_500k`` runs only for sub-quadratic archs (ssm / hybrid /
mostly-sliding-window gemma3); the skip list is data, as in the
reference."""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs import ARCHS, canonical, get_config
from repro_torch.models import make_decode_caches
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeCell("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524_288, 1),
}

# archs with a sub-quadratic (or O(1)-state) long-context path
LONG_CONTEXT_OK = {"falcon_mamba_7b", "jamba_1_5_large_398b", "gemma3_1b"}


def cell_is_runnable(arch: str, shape: str) -> tuple[bool, str]:
    arch = canonical(arch)
    if shape == "long_500k" and arch not in LONG_CONTEXT_OK:
        return False, ("pure full-attention arch: 500k context has no "
                       "sub-quadratic path")
    return True, ""


# the smoke configs cut the attention query chunk 1024 → 16: their cells
# cut the sequence by as much, which keeps the full cells' chunk counts
SMOKE_SEQ_DIVISOR = 256


def smoke_cell(cell: ShapeCell) -> ShapeCell:
    """``cell`` for the smoke configs: the same kind and batch, the
    sequence / ``SMOKE_SEQ_DIVISOR``."""
    return dataclasses.replace(cell, seq_len=cell.seq_len
                               // SMOKE_SEQ_DIVISOR)


def all_cells():
    for arch in ARCHS:
        for shape in SHAPES:
            yield arch, shape


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, cell: ShapeCell) -> dict:
    b, s = cell.global_batch, cell.seq_len
    if cell.kind == "train":
        out = {"labels": _meta((b, s), torch.int32)}
        if cfg.stub_frontend:
            out["embeddings"] = _meta((b, s, cfg.d_model), torch.bfloat16)
        else:
            out["tokens"] = _meta((b, s), torch.int32)
        return out
    if cell.kind == "prefill":
        if cfg.stub_frontend:
            return {"embeddings": _meta((b, s, cfg.d_model),
                                        torch.bfloat16)}
        return {"tokens": _meta((b, s), torch.int32)}
    # decode: one new token against a seq_len cache
    return {"tokens": _meta((b, 1), torch.int32)}


def decode_state_specs(cfg: ModelConfig, cell: ShapeCell):
    caches = make_decode_caches(cfg, cell.global_batch, cell.seq_len,
                                device="meta")
    return caches, _meta((), torch.int32)


def input_specs(arch: str, shape: str) -> dict:
    """Everything the cell's step function consumes, as meta tensors."""
    cfg = get_config(arch)
    cell = SHAPES[shape]
    out = {"batch": batch_specs(cfg, cell)}
    if cell.kind == "decode":
        caches, pos = decode_state_specs(cfg, cell)
        out["caches"], out["pos"] = caches, pos
    return out
