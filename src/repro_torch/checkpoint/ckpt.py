"""Atomic checkpoint save/restore of flat ``{key: array}`` dicts, in the
on-disk format of ``repro.checkpoint.ckpt`` — a checkpoint written by
either package restores in the other.

Two-phase protocol: leaves are written into ``step_N.tmp/`` (one .npy per
leaf, named by its key path and this process's index), fsynced, a
manifest (step, config hash, leaf index, tree structure) is written LAST,
and the directory is atomically renamed to ``step_N/``. A crash at any
point leaves either a complete checkpoint or an ignorable ``.tmp`` — the
restore path only ever sees manifests of complete checkpoints, and boots
from the newest one.

A state dict's keys are its leaves' key paths, in sorted order, as
``jax.tree_util`` flattens a dict. One process writes every leaf: its
index is 0 (the reference's ``jax.process_index()`` on a single host).
``read_leaf`` fetches one leaf without the rest (the wire server's
``wire/last_seq``), and ``prune`` bounds a daemon's store to its newest
checkpoints. ``flatten``/``unflatten`` turn a nested tree into such a dict
and back, with the reference's key paths (``0/blocks/scan/0/attn/wq``).
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
from pathlib import Path

import numpy as np

PROCESS_INDEX = 0


def _treedef(keys) -> str:
    """The dict's structure in ``jax.tree_util``'s repr, so a manifest reads
    the same whichever package wrote it."""
    return "PyTreeDef({" + ", ".join(f"{k!r}: *" for k in keys) + "})"


def flatten(tree, prefix: str = "") -> dict:
    """A nested tree of dicts, lists, tuples and NamedTuples as ``{key
    path: leaf}``, the paths as the reference's ``_path_str`` writes
    ``jax.tree_util``'s (dict keys, sequence indices and NamedTuple field
    names joined by "/")."""
    if hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def unflatten(flat: dict) -> dict:
    """The inverse of ``flatten`` up to container types: nested dicts,
    a level whose keys are 0..n-1 as a list."""
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        *parents, last = path.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[last] = leaf

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and sorted(node) == sorted(map(str, range(len(node)))):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(tree)


def config_fingerprint(obj) -> str:
    return hashlib.sha256(repr(obj).encode()).hexdigest()[:16]


def save(root: str | os.PathLike, step: int, tree: dict,
         config_hash: str = "") -> Path:
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    final = root / f"step_{step:08d}"
    tmp = root / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    index = []
    keys = sorted(tree)
    for key in keys:
        fname = f"{key.replace('/', '.')}.p{PROCESS_INDEX}.npy"
        arr = np.asarray(tree[key])
        with open(tmp / fname, "wb") as f:
            np.save(f, arr)
            f.flush()
            os.fsync(f.fileno())
        index.append({"key": key, "file": fname, "shape": list(arr.shape),
                      "dtype": str(arr.dtype)})
    manifest = {"step": step, "config_hash": config_hash,
                "process_index": PROCESS_INDEX, "leaves": index,
                "treedef": _treedef(keys)}
    mpath = tmp / "MANIFEST.json"
    with open(mpath, "w") as f:
        json.dump(manifest, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish
    return final


def latest_step(root: str | os.PathLike) -> int | None:
    root = Path(root)
    if not root.exists():
        return None
    steps = []
    for d in root.iterdir():
        if d.is_dir() and d.name.startswith("step_") \
                and not d.name.endswith(".tmp") \
                and (d / "MANIFEST.json").exists():
            steps.append(int(d.name.split("_")[1]))
    return max(steps) if steps else None


def read_leaf(root: str | os.PathLike, key: str, step: int | None = None,
              default=None):
    """Read one leaf of a complete checkpoint by its key, without loading
    the rest. The wire server's boot recovery fetches transport-layer
    leaves (``wire/last_seq``) this way: they ride in the session
    checkpoint but are not part of the session's ``load_state_dict``
    contract. Returns ``default`` when the key (or any complete
    checkpoint) is absent."""
    root = Path(root)
    if step is None:
        step = latest_step(root)
    if step is None:
        return default
    d = root / f"step_{step:08d}"
    manifest = json.loads((d / "MANIFEST.json").read_text())
    for e in manifest["leaves"]:
        if e["key"] == key:
            return np.load(d / e["file"])
    return default


def prune(root: str | os.PathLike, keep: int = 2) -> int:
    """Delete all but the newest ``keep`` complete checkpoints under
    ``root`` (plus any torn ``.tmp`` debris). A daemon checkpointing
    every committed window would otherwise grow the store without bound.
    Returns directories removed."""
    root = Path(root)
    if not root.exists():
        return 0
    removed = 0
    complete = []
    for d in root.iterdir():
        if not d.is_dir():
            continue
        if d.name.endswith(".tmp"):
            shutil.rmtree(d, ignore_errors=True)
            removed += 1
        elif d.name.startswith("step_") and (d / "MANIFEST.json").exists():
            complete.append(d)
    complete.sort(key=lambda d: int(d.name.split("_")[1]))
    for d in complete[:-keep] if keep else complete:
        shutil.rmtree(d, ignore_errors=True)
        removed += 1
    return removed


def restore(root: str | os.PathLike, keys, step: int | None = None,
            config_hash: str = "") -> tuple[dict, int]:
    """Load the leaves named by ``keys`` from the newest (or given) complete
    checkpoint. Returns (``{key: array}``, step). Raises FileNotFoundError
    if there is no complete checkpoint."""
    root = Path(root)
    if step is None:
        step = latest_step(root)
    if step is None:
        raise FileNotFoundError(f"no complete checkpoint under {root}")
    d = root / f"step_{step:08d}"
    manifest = json.loads((d / "MANIFEST.json").read_text())
    if config_hash and manifest["config_hash"] \
            and manifest["config_hash"] != config_hash:
        raise ValueError(
            f"checkpoint config hash {manifest['config_hash']} != "
            f"{config_hash} — refusing to restore a different model")
    by_key = {e["key"]: e for e in manifest["leaves"]}
    return {key: np.load(d / by_key[key]["file"].replace(
        f".p{manifest['process_index']}", f".p{PROCESS_INDEX}"))
        for key in keys}, step
