"""Sharding policy (port of ``repro.models.sharding``): parameter specs,
activation pins and the DTensor placements they give.

2-D sharding: parameters are FSDP-sharded over the data axes (``data``,
and ``pod`` when present) and tensor-parallel over ``model``. Activations
keep batch on the data axes; DTensor's sharding propagation inserts the
collectives the weight placements imply, as XLA's SPMD partitioner does
for the reference. KV caches shard their *sequence* dim over ``model`` at
decode, and over (data×model) for the 500k single-sequence cell.

The reference names a ``PartitionSpec`` per leaf; the port keeps that
language as ``PSpec`` (one entry per tensor dim: a mesh axis name, a tuple
of names, or ``None``), so the parity tests compare specs leaf for leaf,
and derives DTensor placements from it (``placements``): for each mesh
dim, ``Shard(d)`` if the spec puts that axis on tensor dim ``d``, else
``Replicate()``.

Every rule guards divisibility: a dim that does not divide the axis
product falls back to replication (e.g. kv-heads=8 on a 16-wide model
axis).

``act()`` is the activation-constraint shim: model code tags activations
by name; the launcher installs a mesh-aware rule set; with none installed,
or on a plain tensor, it is the identity (single-device runs). Parameter
names are the port's flat ones (``blocks.<layer>.attn.wq``): a layer's
spec is the reference's for its stacked ``blocks.scan`` leaf with the
leading ``None`` dropped.
"""

from __future__ import annotations

import contextlib
import threading

import torch

from .config import ModelConfig


class PSpec(tuple):
    """A partition spec: per tensor dim, a mesh axis name, a tuple of
    names (major to minor) or ``None``; a one-name tuple is that name, as
    ``jax.sharding.PartitionSpec`` normalises it."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self):
        return f"PSpec{tuple.__repr__(self)}"


# ------------------------------------------------------------ mesh utils


def mesh_axes(mesh) -> dict[str, int]:
    """Axis name → size, in mesh-dim order, for a ``DeviceMesh`` or for a
    shape-only stand-in with ``axis_names`` and a ``shape`` dict."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def dp_axes(mesh) -> tuple[str, ...]:
    """The data-parallel/FSDP axes: ('pod','data') on multi-pod meshes."""
    return tuple(a for a in mesh_axes(mesh) if a in ("pod", "data"))


def axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = mesh_axes(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def _maybe(mesh, axes, dim: int):
    """axes if dim divides their product else None (replicate)."""
    return axes if dim % axis_size(mesh, axes) == 0 else None


def placements(mesh, spec) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``: per mesh dim,
    ``Shard(d)`` where the spec puts that axis on tensor dim d, else
    ``Replicate()``. A dim spread over several axes lists them in mesh
    order (``("pod", "data")``), which is how DTensor nests shards."""
    from torch.distributed.tensor import Replicate, Shard
    order = list(mesh_axes(mesh))
    where: dict[str, int] = {}
    for d, axes in enumerate(spec):
        if axes is None:
            continue
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        idx = [order.index(a) for a in names]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes of dim {d} are not in "
                             f"mesh order {order}")
        for a in names:
            if a in where:
                raise ValueError(f"spec {spec} uses axis {a!r} twice")
            where[a] = d
    return tuple(Shard(where[a]) if a in where else Replicate()
                 for a in order)


# ------------------------------------------------------- activation shim

_TLS = threading.local()


def _sanitize(mesh, spec, shape) -> PSpec:
    """The rule ``spec`` fitted to ``shape``: missing trailing dims are
    None, an axis that does not divide its dim falls back to None, and of
    the ``"model?"`` candidates only the first whose size divides the
    model axis takes it."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    fixed = []
    placed = False
    for dim, axes in zip(shape, entries[: len(shape)]):
        if axes == "model?":
            if not placed and dim % axis_size(mesh, "model") == 0 \
                    and dim > 0:
                fixed.append("model")
                placed = True
            else:
                fixed.append(None)
            continue
        if axes is not None and dim % axis_size(mesh, axes) != 0:
            axes = None
        fixed.append(axes)
    return PSpec(*fixed)


def act_spec(shape, name: str):
    """The spec ``act`` would pin a tensor of ``shape`` tagged ``name`` to
    under the installed rules, or None when no rule applies."""
    rules = getattr(_TLS, "rules", None)
    mesh = getattr(_TLS, "mesh", None)
    if not rules or name not in rules or mesh is None:
        return None
    return _sanitize(mesh, rules[name], tuple(shape))


def act(x, name: str):
    """Pin ``x`` to the installed activation rule for ``name``: a
    redistribute of a DTensor to the rule's placements (sanitized against
    the concrete shape). The identity with no rules installed, or for a
    plain tensor."""
    if getattr(_TLS, "rules", None) is None or not _is_dt(x):
        return x
    spec = act_spec(x.shape, name)
    if spec is None:
        return x
    mesh = _TLS.mesh
    want = placements(mesh, spec)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


@contextlib.contextmanager
def activation_rules(mesh, rules: dict):
    old = (getattr(_TLS, "rules", None), getattr(_TLS, "mesh", None))
    _TLS.rules, _TLS.mesh = rules, mesh
    try:
        yield
    finally:
        _TLS.rules, _TLS.mesh = old


# ----------------------------------------------------------- param rules


# Rules: leaf-path suffix → axis assignment for the TRAILING dims. Leading
# dims (the reference's stacked [num_periods] axis) are padded with None,
# so one rule serves both layouts.
_TRAILING_RULES: list[tuple[tuple[str, ...], tuple]] = [
    (("attn.wq", "attn.wk", "attn.wv"), ("DP", "TP", None)),
    (("attn.wo",), ("TP", None, "DP")),
    (("attn.bq", "attn.bk", "attn.bv"), ("TP", None)),
    (("mlp.wi", "mlp.wg", "shared.wi", "shared.wg"), ("DP", "TP")),
    (("mlp.wo", "shared.wo"), ("TP", "DP")),
    (("experts.wi", "experts.wg"), ("TP", "DP", None)),
    (("experts.wo",), ("TP", None, "DP")),
    (("router",), ("DP", None)),
    (("mamba.in_proj",), ("DP", "TP")),
    (("mamba.out_proj",), ("TP", "DP")),
    (("mamba.conv_w",), (None, "TP")),
    (("mamba.conv_b", "mamba.dt_bias", "mamba.d_skip"), ("TP",)),
    (("mamba.x_proj", "mamba.a_log"), ("TP", None)),
]


def _leaf_spec(mesh, cfg: ModelConfig, path: str, shape) -> PSpec:
    dp = dp_axes(mesh)
    nd = len(shape)

    def m(axes, dim):  # shorthand with divisibility guard
        if axes == "DP":
            axes = dp
        elif axes == "TP":
            axes = "model"
        return _maybe(mesh, axes, dim) if axes is not None else None

    if path.endswith("embed"):
        return PSpec(m("TP", shape[0]), m("DP", shape[1]))
    if path.endswith("lm_head"):
        return PSpec(m("DP", shape[0]), m("TP", shape[1]))
    if "norm" in path or path.endswith(("ln1", "ln2")):
        return PSpec(*([None] * nd))
    for suffixes, axes in _TRAILING_RULES:
        if path.endswith(suffixes):
            k = len(axes)
            tail = [m(a, shape[nd - k + i]) for i, a in enumerate(axes)]
            return PSpec(*([None] * (nd - k) + tail))
    return PSpec(*([None] * nd))  # default: replicate


def param_pspecs(mesh, cfg: ModelConfig, params: dict) -> dict[str, PSpec]:
    """Spec per parameter of ``params`` ({flat name: tensor}, e.g.
    ``models.param_specs(cfg)``)."""
    return {name: _leaf_spec(mesh, cfg, name, tuple(t.shape))
            for name, t in params.items()}


def param_shardings(mesh, cfg: ModelConfig, params: dict) -> dict:
    """Placements per parameter (``placements`` of ``param_pspecs``)."""
    return {name: placements(mesh, s)
            for name, s in param_pspecs(mesh, cfg, params).items()}


# ----------------------------------------------------------- batch rules


def batch_pspecs(mesh, batch: dict) -> dict[str, PSpec]:
    """tokens/labels [B,S] and embeddings [B,S,D]: batch over dp axes
    (replicated when B doesn't divide — the B=1 long-context cell)."""
    dp = dp_axes(mesh)
    return {k: PSpec(_maybe(mesh, dp, t.shape[0]),
                     *([None] * (t.dim() - 1)))
            for k, t in batch.items()}


def cache_pspecs(mesh, cfg: ModelConfig, caches: list,
                 shard_seq: str = "model") -> list:
    """Decode-cache specs, one tuple per layer (the caches' layout).
    Attention KV [B, Smax, Hkv, Dh]: batch→dp, seq→``shard_seq``
    ("model", "all" = data+model for B=1, or "none"; with "none" the heads
    take the model axis). Mamba h [B, din, st] / conv [B, conv-1, din]:
    din→model."""
    dp = dp_axes(mesh)
    seq_axes = {"model": "model", "all": dp + ("model",),
                "none": None}[shard_seq]

    def spec(leaf):
        shp = tuple(leaf.shape)
        nd = len(shp)
        lead = [None] * (nd - 4)
        if nd >= 4 and shp[-1] == cfg.head_dim \
                and shp[-2] == cfg.num_kv_heads:   # attn KV [.., B, S, H, Dh]
            return PSpec(*lead, _maybe(mesh, dp, shp[-4]),
                         _maybe(mesh, seq_axes, shp[-3]),
                         _maybe(mesh, "model", shp[-2]) if seq_axes is None
                         else None, None)
        lead = [None] * (nd - 3)
        if nd >= 3 and shp[-1] == cfg.ssm_state:   # mamba h [.., B, din, st]
            return PSpec(*lead, _maybe(mesh, dp, shp[-3]),
                         _maybe(mesh, "model", shp[-2]), None)
        if nd >= 3 and shp[-1] == cfg.d_inner:     # conv tail [.., B, c-1, di]
            return PSpec(*lead, _maybe(mesh, dp, shp[-3]), None,
                         _maybe(mesh, "model", shp[-1]))
        return PSpec(*([None] * nd))

    return [tuple(spec(leaf) for leaf in layer) for layer in caches]


def default_activation_rules(mesh, cfg: ModelConfig,
                             kind: str = "train") -> dict[str, PSpec]:
    """Activation pins by tag, the reference's rule set for ``kind``
    ("train", "prefill" or "decode")."""
    dp = dp_axes(mesh)
    if kind == "decode":
        attn_logits = PSpec(dp, None, None, None, "model")  # S = cache
        hidden = PSpec(dp, None, None)
        q_heads = PSpec(dp, None, None, None)  # model axis spent on cache-S
    else:
        # q/head-sharded attention logits: one "model?" candidate lands on
        # kv-groups or the q-chunk dim for awkward head counts
        attn_logits = PSpec(dp, "model?", "model?", "model?", None)
        # sequence-parallel residual stream, except for the ssm/hybrid
        # families (mamba's chunked scan wants the full local sequence)
        sp = not (cfg.family in ("ssm", "hybrid") or cfg.attn_every)
        hidden = PSpec(dp, "model" if sp else None, None)
        q_heads = PSpec(dp, None, "model?", None)
    return {
        "hidden": hidden,                                  # [B, S, D]
        "attn_logits": attn_logits,                        # [B, r, g, qc, S]
        "attn_out": PSpec(dp, None, "model?", "model?", None),  # [B,qc,r,g,Dh]
        "q_heads": q_heads,                                # [B, S, H, Dh]
        "kv": PSpec(dp, None, None, None),                 # [B, S, Hkv, Dh]
        "ffn_inner": PSpec(dp, None, "model"),             # [B, S, F]
        "moe_dispatch": PSpec(dp, None, "model", None),    # [G, S, E, C]
        "moe_inner": PSpec(dp, "model", None, None),       # [G, E, C, D/F]
        "mamba_state": PSpec(dp, None, "model", None),     # [B, L, din, st]
        "logits_chunk": PSpec(dp, None, "model"),          # [B, chunk, V]
    }


# ------------------------------------------------------------- DTensors


def local_shape(mesh, spec, shape) -> tuple[int, ...]:
    """A rank's shard shape of a tensor of ``shape`` under ``spec`` (the
    guards make every sharded dim divide its axes)."""
    out = list(shape)
    for d, axes in enumerate(spec):
        out[d] //= axis_size(mesh, axes)
    return tuple(out)


def distribute(t: torch.Tensor, mesh, spec):
    """``t`` (the full tensor, the same on every rank) as a DTensor with
    ``spec``'s placements; each rank keeps its own shard, no collective."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, mesh, placements(mesh, spec),
                             src_data_rank=None)


def own_shard(like, t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of the full tensor ``t`` under DTensor
    ``like``'s placements (a plain tensor on ``like``'s local device)."""
    from torch.distributed.tensor import distribute_tensor
    local = like.to_local()
    return distribute_tensor(t.to(local.device), like.device_mesh,
                             like.placements, src_data_rank=None).to_local()


def full(t):
    """A DTensor's full value as a plain tensor (a plain tensor as is)."""
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def shard_model_(model, mesh):
    """Replace every parameter of ``model`` by a DTensor with its
    ``param_pspecs`` placements (in place; ``requires_grad`` kept)."""
    params = dict(model.named_parameters())
    specs = param_pspecs(mesh, model.cfg, params)
    for name, p in params.items():
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name) if mod_name else model
        mod._parameters[leaf] = torch.nn.Parameter(
            distribute(p.detach(), mesh, specs[name]),
            requires_grad=p.requires_grad)
    return model


def _shard_range(t, dim: int) -> tuple[int, int]:
    """(first index, length) of this rank's shard of DTensor ``t`` along
    ``dim``, which its placements split evenly (nested in mesh order):
    plain arithmetic on the mesh coordinate."""
    from torch.distributed.tensor import Shard
    mesh = t.device_mesh
    coord = mesh.get_coordinate()
    n, lo = t.shape[dim], 0
    for m, p in enumerate(t.placements):
        if isinstance(p, Shard) and p.dim == dim:
            k = mesh.size(m)
            if n % k:
                raise ValueError(f"dim {dim} of {tuple(t.shape)} does not "
                                 f"split evenly over mesh dim {m}")
            n //= k
            lo += coord[m] * n
    return lo, n


def write_seq_slot_(cache, value, pos: int) -> None:
    """``cache[:, pos:pos+1] = value`` for a cache [B, S, ...] and value
    [B, 1, ...], in place. A DTensor cache sharded on S is written where
    its shard holds ``pos``: a local computation on each rank's shard
    (DTensor has no strategy for an in-place write into a sharded dim)."""
    from torch.distributed.tensor import Replicate, Shard
    if not _is_dt(cache):
        cache[:, pos:pos + 1] = value.to(cache.dtype)
        return
    mesh = cache.device_mesh
    want = tuple(Replicate() if (isinstance(p, Shard) and p.dim == 1)
                 else p for p in cache.placements)
    v = _as_dtensor(value, mesh).redistribute(mesh, want).to_local()
    v = v.to(cache.dtype)
    lo, n = _shard_range(cache, 1)
    if lo <= pos < lo + n:
        cache.to_local()[:, pos - lo:pos - lo + 1] = v


# --------------------------------------------------- local computations
#
# DTensor lowers ``torch.einsum`` to views and ``bmm``; a view that merges
# or splits a dim sharded on two mesh axes has no strategy. The model's
# contractions run here instead: per mesh dim the operands agree on one
# sharded letter (the one the largest operand is sharded on; the others
# are chunked locally, or gathered where they hold another), each rank
# runs the same einsum on its shards, and a contracted sharded letter
# leaves the output ``Partial`` (reduced where a later op needs it). On
# plain tensors these are the plain ops, so single-device results are
# unchanged.


def _as_dtensor(t, mesh):
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _contract(eq: str, ops):
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    lhs, out = eq.replace(" ", "").split("->")
    terms = lhs.split(",")
    mesh = next(o.device_mesh for o in ops if isinstance(o, DTensor))
    ops = [_as_dtensor(o, mesh) for o in ops]
    size = {}
    for term, o in zip(terms, ops):
        size.update(zip(term, o.shape))
    want = [list(o.placements) for o in ops]
    grad = [list(o.placements) for o in ops]
    out_pl = []
    for m in range(mesh.ndim):
        for i, o in enumerate(ops):
            if want[i][m].is_partial():
                want[i][m] = Replicate()
        score: dict[str, int] = {}
        for i, o in enumerate(ops):
            p = want[i][m]
            if isinstance(p, Shard):
                letter = terms[i][p.dim]
                score[letter] = score.get(letter, 0) + o.numel()
        if not score:
            for i in range(len(ops)):
                grad[i][m] = Replicate()
            out_pl.append(Replicate())
            continue
        letter = max(score, key=score.get)
        for i, term in enumerate(terms):
            want[i][m] = (Shard(term.index(letter)) if letter in term
                          else Replicate())
            # an operand every rank holds whole meets a different shard of
            # the letter on each: its gradient is the sum of theirs
            grad[i][m] = want[i][m] if letter in term else Partial()
        out_pl.append(Shard(out.index(letter)) if letter in out
                      else Partial())
    local = [(o.redistribute(mesh, w) if list(o.placements) != w else o)
             .to_local(grad_placements=g)
             for o, w, g in zip(ops, want, grad)]
    y = torch.einsum(f"{','.join(terms)}->{out}", *local)
    return _wrap(y, mesh, out_pl, tuple(size[c] for c in out))


class _FromLocal(torch.autograd.Function):
    """``DTensor.from_local`` whose gradient reaches the local tensor with
    every ``Partial`` placement of the output made ``Replicate``: a
    partial output's shard is one rank's summand, so its gradient is the
    whole one."""

    @staticmethod
    def forward(ctx, local, mesh, pl, shape, stride):
        from torch.distributed.tensor import DTensor, Replicate
        ctx.mesh = mesh
        ctx.grad_pl = tuple(Replicate() if p.is_partial() else p
                            for p in pl)
        return DTensor.from_local(local, mesh, pl, run_check=False,
                                  shape=shape, stride=stride)

    @staticmethod
    def backward(ctx, grad):
        if tuple(grad.placements) != ctx.grad_pl:
            grad = grad.redistribute(ctx.mesh, ctx.grad_pl)
        return grad.to_local(), None, None, None, None


def _wrap(local, mesh, pl, shape):
    """A rank's ``local`` shard as the DTensor of global ``shape``
    (contiguous) with placements ``pl``."""
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return _FromLocal.apply(local.contiguous(), mesh, tuple(pl),
                            tuple(shape), tuple(reversed(stride)))


_PLAIN = (torch.Tensor, torch.nn.Parameter)


def _is_dt(*ts) -> bool:
    """Whether any of ``ts`` is a DTensor (plain tensors answer without
    touching ``torch.distributed``)."""
    if all(type(t) in _PLAIN for t in ts):
        return False
    from torch.distributed.tensor import DTensor
    return any(isinstance(t, DTensor) for t in ts)


def einsum(eq: str, *ops):
    """``torch.einsum(eq, *ops)``; on DTensors a local einsum per shard."""
    if not _is_dt(*ops):
        return torch.einsum(eq, *ops)
    return _contract(eq, ops)


_LETTERS = "abcdefghijklmnopqrstuvwxyz"


def matmul(a, b):
    """``a @ b`` for a [..., K] and b [K, N]; on DTensors a local product
    per shard."""
    if not _is_dt(a, b):
        return a @ b
    lead = _LETTERS[:a.dim() - 1]
    return _contract(f"{lead}y,yz->{lead}z", (a, b))


def take_rows(table, idx):
    """``table[idx]``: rows of an embedding table [V, D]. On DTensors the
    table is gathered whole and each rank looks up its own ids (DTensor's
    index strategy cannot pair a table sharded on D with ids sharded on
    the same mesh axis)."""
    if not _is_dt(table, idx):
        return table[idx]
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh = next(t.device_mesh for t in (table, idx)
                if isinstance(t, DTensor))
    idx = _as_dtensor(idx, mesh)
    pl = [p if p.is_shard() else Replicate() for p in idx.placements]
    table = _as_dtensor(table, mesh).redistribute(
        mesh, [Replicate()] * mesh.ndim).to_local(
            grad_placements=[Partial() if p.is_shard() else Replicate()
                             for p in pl])
    rows = table[idx.to_local()]
    return _wrap(rows, mesh, pl, tuple(idx.shape) + (table.shape[1],))


def pick_last(logits, idx):
    """``logits.gather(-1, idx[..., None])[..., 0]``. On a DTensor whose
    last dim is sharded each rank picks the ids its shard holds and leaves
    0 elsewhere, so the result is ``Partial`` over those mesh dims (the
    vocab-parallel pick; DTensor's gather strategy gives a masked partial
    that its subtraction cannot mix with the log-sum-exp)."""
    if not _is_dt(logits, idx):
        return logits.gather(-1, idx[..., None])[..., 0]
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = logits.device_mesh
    last = logits.dim() - 1
    idx_pl, out_pl = [], []
    for p in logits.placements:
        if isinstance(p, Shard) and p.dim == last:
            idx_pl.append(Replicate())
            out_pl.append(Partial())
        else:
            idx_pl.append(p if isinstance(p, Shard) else Replicate())
            out_pl.append(idx_pl[-1])
    idx = _as_dtensor(idx, mesh).redistribute(mesh, idx_pl).to_local()
    lo, n = _shard_range(logits, last)
    local = idx - lo
    inside = (local >= 0) & (local < n)
    got = logits.to_local().gather(
        -1, local.clamp(0, n - 1)[..., None])[..., 0]
    got = torch.where(inside, got, torch.zeros_like(got))
    return _wrap(got, mesh, out_pl, tuple(logits.shape[:-1]))
