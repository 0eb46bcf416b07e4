"""Top-level LM (port of ``repro.models.model``): embeddings → block stack →
norm → (chunked) logits/loss, plus prefill/decode with explicit per-layer
caches.

[audio]/[vlm] archs use the stubbed frontend: the batch carries
precomputed frame/patch embeddings [B, S, D] instead of token ids, and
decode still feeds tokens through the (stub) embed table.

The parameters are an ``LM`` module whose state-dict names are the
reference's parameter tree flattened with dots, its stacked ``blocks.scan``
unrolled into ``blocks.<layer>`` (``unstack_params``; ``stack_params`` is
its inverse, for gradients, moments and checkpoints too). The caches are one
tuple per layer in layer order: (k, v) [B, S, Hkv, Dh] for attention,
(h [B, din, st] float32, conv [B, ssm_conv - 1, din]) for mamba.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch
from torch import nn

from repro_torch.device import resolve_device

from .config import ModelConfig
from .layers import dtype_of, normal_, param, rms_norm
from .sharding import (_is_dt, act, full, matmul, own_shard, pick_last,
                       take_rows)
from .transformer import Block, apply_stack

AUX_LOSS_COEF = 0.01


class LM(nn.Module):
    """``embed`` [V, D], ``blocks`` (one ``Block`` per layer, in order),
    float32 ``final_norm`` [D], ``lm_head`` [D, V]; weights in
    ``cfg.dtype``. Built uninitialised (``init_params`` fills it)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        dtype = dtype_of(cfg)
        d, v = cfg.d_model, cfg.vocab_size
        self.cfg = cfg
        self.embed = param((v, d), dtype, device)
        self.blocks = nn.ModuleList(
            Block(cfg, i % cfg.period, dtype, device)
            for i in range(cfg.num_layers))
        self.final_norm = param((d,), torch.float32, device)
        self.lm_head = param((d, v), dtype, device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        normal_(self.embed, gen, 1.0)
        for block in self.blocks:
            block.reset_parameters(gen)
        self.final_norm.zero_()
        normal_(self.lm_head, gen, self.cfg.d_model ** -0.5)

    def forward(self, x, positions, mode: str = "train", caches=None,
                pos=None):
        """The block stack on embedded inputs x [B, S, D].
        Returns (h, per-layer caches or None, summed aux loss)."""
        return apply_stack(self.blocks, x, positions, mode, caches=caches,
                           pos=pos)


# ------------------------------------------------------------------ init


def init_params(cfg: ModelConfig, generator: torch.Generator | int = 0,
                device=None) -> LM:
    """A model with random weights drawn on ``device`` (default: the CUDA
    card) from ``generator`` (or a generator seeded with that int): the
    reference's distributions (normal × its std, zeros for norms and
    biases; mamba ``dt_bias`` 0.5, ``a_log`` = log(1..st), ``d_skip`` 1).
    The values differ from the reference's PRNG; ``params_from_numpy``
    carries the reference's own weights across."""
    dev = resolve_device(device)
    if not isinstance(generator, torch.Generator):
        generator = torch.Generator(device=dev).manual_seed(int(generator))
    model = LM(cfg, dev)
    with torch.no_grad():
        model.reset_parameters(generator)
    return model.eval()


def param_specs(cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """Every parameter as a ``meta`` tensor (shape and dtype, no memory)."""
    return dict(LM(cfg, device="meta").named_parameters())


def _as_tensor(a) -> torch.Tensor:
    """A numpy leaf as a tensor. bfloat16 comes as ml_dtypes' bfloat16 or
    as the 2-byte void that ``np.save`` writes for it (``|V2``): either
    way its bits are carried."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16" or (a.dtype.kind == "V"
                                       and a.dtype.itemsize == 2):
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(a.copy())


def as_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host numpy array; bfloat16 as the 2-byte void that
    ``np.save`` writes for ml_dtypes' bfloat16 (numpy has no bfloat16 of
    its own), so the bits round-trip through ``_as_tensor``. A DTensor
    gives its full value (a collective: every rank calls it)."""
    t = full(t.detach()).cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _layer_slot(cfg: ModelConfig, i: int) -> tuple[str, int, int | None]:
    """Where layer i sits in the reference's ``blocks``: ("scan", j, r),
    period repetition r of ``scan[j]``, or ("tail", j, None)."""
    n = cfg.num_periods * cfg.period
    if i < n:
        return "scan", i % cfg.period, i // cfg.period
    return "tail", i - n, None


def unstack_params(tree: dict, cfg: ModelConfig) -> dict[str, Any]:
    """The reference's parameter tree as the port's flat names (the
    ``LM``'s ``named_parameters()``): ``blocks.scan[j]`` (stacked over
    ``num_periods``) unstacks into layers r·period + j and
    ``blocks.tail[j]`` into layer num_periods·period + j; every leaf keeps
    its layout (heads stay rep-major). The same map carries gradients and
    AdamW moments (their trees have the parameters' structure)."""
    flat: dict[str, Any] = {}

    def put(prefix, node, r=None):
        if isinstance(node, dict):
            for k, v in node.items():
                put(f"{prefix}.{k}" if prefix else k, v, r)
        else:
            flat[prefix] = node if r is None else np.asarray(node)[r]

    put("", {k: v for k, v in tree.items() if k != "blocks"})
    for i in range(cfg.num_layers):
        where, j, r = _layer_slot(cfg, i)
        put(f"blocks.{i}", tree["blocks"][where][j], r)
    return flat


def stack_params(flat: dict[str, Any], cfg: ModelConfig) -> dict:
    """The inverse of ``unstack_params``: the port's flat names (numpy
    leaves) as the reference's tree, ``blocks.scan[j]`` stacked over
    ``num_periods`` and ``blocks.tail`` a list."""
    tree: dict = {}
    layers: dict[int, dict] = {}
    for name, leaf in flat.items():
        parts = name.split(".")
        if parts[0] == "blocks":
            node = layers.setdefault(int(parts[1]), {})
            parts = parts[2:]
        else:
            node = tree
        for k in parts[:-1]:
            node = node.setdefault(k, {})
        node[parts[-1]] = leaf

    def stack(nodes):
        if isinstance(nodes[0], dict):
            return {k: stack([n[k] for n in nodes]) for k in nodes[0]}
        return np.stack([np.asarray(n) for n in nodes])

    scan = [stack([layers[r * cfg.period + j]
                   for r in range(cfg.num_periods)])
            for j in range(cfg.period)]
    tail = [layers[cfg.num_periods * cfg.period + j]
            for j in range(cfg.tail_layers)]
    tree["blocks"] = {"scan": scan, "tail": tail}
    return tree


def load_flat_(tensors: dict[str, torch.Tensor], flat: dict[str, Any],
               what: str = "parameter") -> None:
    """Copy numpy leaves ``flat`` into ``tensors`` (the same names), each
    cast to its tensor's dtype and device; the names and shapes must
    match. A DTensor takes its own shard of the leaf."""
    if set(flat) != set(tensors):
        raise ValueError(f"{what} trees differ: only in the tree "
                         f"{sorted(set(flat) - set(tensors))}, only in the "
                         f"model {sorted(set(tensors) - set(flat))}")
    with torch.no_grad():
        for name, leaf in flat.items():
            t = _as_tensor(leaf)
            if t.shape != tensors[name].shape:
                raise ValueError(f"{name}: shape {tuple(t.shape)} != "
                                 f"{tuple(tensors[name].shape)}")
            dst = tensors[name]
            if _is_dt(dst):
                dst.to_local().copy_(own_shard(dst, t))
            else:
                dst.copy_(t)


def params_from_numpy(tree: dict, cfg: ModelConfig, device=None) -> LM:
    """The reference's parameter tree (numpy leaves, as
    ``jax.tree.map(np.asarray, repro.models.init_params(key, cfg))``) as
    the port's ``LM`` on ``device`` (``unstack_params``)."""
    model = LM(cfg, resolve_device(device))
    load_flat_(dict(model.named_parameters()), unstack_params(tree, cfg))
    return model.eval()


def params_to_numpy(model: LM, cfg: ModelConfig) -> dict:
    """The port's parameters as the reference's tree of numpy leaves
    (``stack_params``; bfloat16 as ``as_numpy`` gives it)."""
    return stack_params({n: as_numpy(p) for n, p in model.named_parameters()},
                        cfg)


# ----------------------------------------------------------------- embed


def embed_inputs(model: LM, batch: dict) -> torch.Tensor:
    dtype = dtype_of(model.cfg)
    if "embeddings" in batch:  # stubbed modality frontend
        return act(batch["embeddings"].to(dtype), "hidden")
    return act(take_rows(model.embed, batch["tokens"].long()).to(dtype),
               "hidden")


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


# ------------------------------------------------------------------ loss


def chunked_ce_loss(h, lm_head, labels, chunk: int):
    """Cross-entropy over sequence chunks, never materialising the whole
    [B, S, V] logits."""
    b, s, _ = h.shape
    chunk = min(chunk, s)
    assert s % chunk == 0
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(s // chunk):
        hc = h[:, i * chunk:(i + 1) * chunk]
        yc = labels[:, i * chunk:(i + 1) * chunk].long()
        logits = act(matmul(hc, lm_head).float(),             # [B, c, V]
                     "logits_chunk")
        lse = torch.logsumexp(logits, dim=-1)
        gold = pick_last(logits, yc)
        total = total + torch.sum(lse - gold)
    return total / (b * s)


def loss_fn(model: LM, batch: dict):
    """Next-token CE (+ MoE aux). batch: tokens|embeddings, labels."""
    x = embed_inputs(model, batch)
    b, s = x.shape[:2]
    h, _, aux = model(x, _positions(b, s, x.device), "train")
    h = rms_norm(h, model.final_norm)
    ce = chunked_ce_loss(h, model.lm_head, batch["labels"],
                         model.cfg.logits_chunk)
    return ce + AUX_LOSS_COEF * aux, {"ce": ce, "aux": aux}


# -------------------------------------------------------------- serving


class DecodeState(NamedTuple):
    caches: list       # one cache tuple per layer, in layer order
    pos: int           # next write index


def make_decode_caches(cfg: ModelConfig, batch_size: int, max_seq: int,
                       device=None) -> list:
    """Zero-initialised per-layer caches on ``device`` (default: the CUDA
    card; ``"meta"`` gives shapes only)."""
    dev = (torch.device(device) if str(device) == "meta"
           else resolve_device(device))
    dtype = dtype_of(cfg)
    out = []
    for i in range(cfg.num_layers):
        if cfg.layer_kind(i % cfg.period) == "attn":
            shp = (batch_size, max_seq, cfg.num_kv_heads, cfg.head_dim)
            out.append((torch.zeros(shp, dtype=dtype, device=dev),
                        torch.zeros(shp, dtype=dtype, device=dev)))
        else:
            out.append((
                torch.zeros(batch_size, cfg.d_inner, cfg.ssm_state,
                            dtype=torch.float32, device=dev),
                torch.zeros(batch_size, cfg.ssm_conv - 1, cfg.d_inner,
                            dtype=dtype, device=dev)))
    return out


def decode_cache_specs(cfg: ModelConfig, batch_size: int,
                       max_seq: int) -> list:
    return make_decode_caches(cfg, batch_size, max_seq, device="meta")


@torch.no_grad()
def prefill(model: LM, batch: dict):
    """Forward over a full prompt; returns (last-position logits [B, 1, V]
    float32, per-layer caches). Attention caches cover [0, S); decode
    continues at S."""
    x = embed_inputs(model, batch)
    b, s = x.shape[:2]
    h, caches, _ = model(x, _positions(b, s, x.device), "prefill")
    h = rms_norm(h, model.final_norm)
    logits = matmul(h[:, -1:, :], model.lm_head).float()
    return logits, caches


@torch.no_grad()
def decode_step(model: LM, tokens, state: DecodeState):
    """One serving step: tokens [B, 1] → (logits [B, 1, V], new state).
    The caches are updated in place."""
    x = take_rows(model.embed, tokens.long()).to(dtype_of(model.cfg))
    b = x.shape[0]
    positions = torch.full((b, 1), state.pos, dtype=torch.int32,
                           device=x.device)
    h, new_caches, _ = model(x, positions, "decode", caches=state.caches,
                             pos=state.pos)
    h = rms_norm(h, model.final_norm)
    logits = matmul(h, model.lm_head).float()
    return logits, DecodeState(caches=new_caches, pos=state.pos + 1)
