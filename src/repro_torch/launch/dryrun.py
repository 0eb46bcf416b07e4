"""Multi-pod dry run (port of ``repro.launch.dryrun``).

For every (architecture × input shape × mesh) cell: open a fake process
group of the production mesh's size (256 ranks for ``single``, 512 for
``multi``; ``FakeStore`` with backend ``"fake"``: collectives return at
once), build ``launch.mesh.make_production_mesh`` on it, and trace the
cell's sharded step (``launch.steps.build_cell``) once on ``meta`` local
shards: every op of the step, forward, backward and optimizer, runs
through DTensor's sharding propagation and the port's local computations
on shards that have shapes and dtypes but no memory, so the distribution
config is proven coherent at full width without hardware. (The meta
device rather than ``FakeTensorMode``: the same ops on the same shapes,
with the local ops dispatched in C++ instead of through the fake mode's
Python, about 3.5 times faster.) One JSON per cell records ``status``,
``chips``, ``seconds`` (``build`` and ``trace``), ``memory``, ``tokens``
and ``model``:

- ``memory.argument_size_in_bytes``: one rank's shards of the step's
  inputs (parameters, AdamW moments and step, batch, decode caches and
  position, the position counted as the reference's int32 scalar);
- ``temp_size_in_bytes``: the peak of live meta-tensor bytes while the
  step traces (``LiveBytes``: one rank's local shards), less the
  arguments; ``per_device_total_bytes`` is their sum; ``device_types``
  the devices of every tensor the trace made, and ``cuda_initialized``
  whether CUDA was ever initialised in the process (never: no card is
  touched).

``hlo`` is ``launch.op_analysis``'s summary of the same trace (one run,
under ``LiveBytes`` and the op counter together): the FLOPs of the
contractions, the operand bytes of the collectives and the traffic of
the ops one rank runs on its local shards; ``cost`` holds its ``flops``
and ``bytes accessed`` totals, the same numbers, since nothing is
undercounted (the reference's ``cost_analysis`` visits a loop body once;
here every layer and recompute runs). ``--keep-ops`` writes one line per
counted op to ``{arch}__{shape}__{mesh}.ops.txt`` beside the JSON.

The fake group lives in this process only, and the run touches no card:
the trace's tensors are meta tensors (``torch.cuda.memory_allocated()``
stays 0).

``--smoke`` traces the reduced configs on the cells cut by
``shapes.smoke_cell`` (sequence / 64, the smoke configs' chunk cut).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3_405b \\
      --shape train_4k --mesh single --out experiments/dryrun_torch
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --smoke \\
      --mesh both --out /tmp/dryrun [--keep-ops]
  PYTHONPATH=src python -m repro_torch.launch.roofline --dir /tmp/dryrun
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time
import traceback
import weakref
from pathlib import Path

import torch

from repro_torch.configs import ARCHS, canonical, get_config, \
    get_smoke_config
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.op_analysis import OpCounter
from repro_torch.launch.shapes import SHAPES, cell_is_runnable, smoke_cell
from repro_torch.launch.steps import build_cell

MESHES = {"single": False, "multi": True}
WORLD = {"single": 256, "multi": 512}


@contextlib.contextmanager
def fake_world(world_size: int):
    """A fake process group of ``world_size`` ranks (this process is rank
    0), destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def local_bytes(tree) -> int:
    """Bytes of this rank's shards of every tensor in ``tree`` (nested
    dicts, lists, tuples, an ``nn.Module``'s parameters); an int is an
    int32 scalar."""
    if isinstance(tree, torch.nn.Module):
        return local_bytes(dict(tree.named_parameters()))
    if isinstance(tree, dict):
        return sum(local_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(local_bytes(v) for v in tree)
    if isinstance(tree, int):
        return 4
    if isinstance(tree, torch.Tensor):
        from torch.distributed.tensor import DTensor
        t = tree.to_local() if isinstance(tree, DTensor) else tree
        return t.numel() * t.element_size()
    raise TypeError(type(tree))


class LiveBytes:
    """The peak of the bytes held by live tensor storages while a block
    runs: the arguments ``track``ed before it, and every tensor an op
    returns (a DTensor's local shard), each storage counted once and
    dropped when it is freed. A dispatch mode at op boundaries, so
    transients inside one op are not seen. (``MemTracker`` gives the same
    peak within 2 % on llama3_405b × 16 layers, at 2.4 times the cost.)"""

    def __init__(self):
        self._refs: dict = {}
        self.cur = self.peak = 0
        self.devices: set[str] = set()

    def track(self, tree) -> None:
        from torch.distributed.tensor import DTensor
        from torch.utils._pytree import tree_leaves
        if isinstance(tree, torch.nn.Module):
            tree = list(tree.parameters())
        for t in tree_leaves(tree, is_leaf=lambda x: isinstance(
                x, torch.nn.Module)):
            if isinstance(t, torch.nn.Module):
                self.track(t)
                continue
            if isinstance(t, DTensor):
                t = t._local_tensor
            if not isinstance(t, torch.Tensor):
                continue
            self.devices.add(t.device.type)
            st = t.untyped_storage()
            key = id(st)
            if key in self._refs:
                continue
            n = st.nbytes()

            def gone(_, key=key, n=n):
                self.cur -= n
                self._refs.pop(key, None)

            self._refs[key] = weakref.ref(st, gone)
            self.cur += n
            self.peak = max(self.peak, self.cur)

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        tracker = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                tracker.track(out)
                return out

        self._mode = _Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self._mode.__exit__(*exc)


def _trace(fn, args, keep_ops: bool = False) -> tuple[LiveBytes,
                                                      OpCounter]:
    """Run ``fn(*args)`` once under a ``LiveBytes`` that tracked the
    arguments first and an ``OpCounter`` (entered first, so ``LiveBytes``
    sees the DTensor ops and the counter the local ones)."""
    tracker = LiveBytes()
    tracker.track(args)
    counter = OpCounter(keep_ops=keep_ops)
    with counter, tracker:
        fn(*args)
    return tracker, counter


def run_cell(arch: str, shape: str, mesh_name: str, out_dir: Path,
             force: bool = False, smoke: bool = False,
             keep_ops: bool = False) -> dict:
    """Trace one cell under the current fake process group (of
    ``WORLD[mesh_name]`` ranks) and write its JSON record."""
    arch = canonical(arch)
    out_path = out_dir / f"{arch}__{shape}__{mesh_name}.json"
    if out_path.exists() and not force:
        rec = json.loads(out_path.read_text())
        if rec.get("status") in ("ok", "skip"):
            print(f"[cached] {arch} × {shape} × {mesh_name}: "
                  f"{rec['status']}")
            return rec
    runnable, why = cell_is_runnable(arch, shape)
    rec = {"arch": arch, "shape": shape, "mesh": mesh_name, "smoke": smoke,
           "timestamp": time.strftime("%Y-%m-%d %H:%M:%S")}
    if not runnable:
        rec.update(status="skip", reason=why)
        out_path.write_text(json.dumps(rec, indent=1))
        print(f"[skip]   {arch} × {shape} × {mesh_name}: {why}")
        return rec
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    cell = smoke_cell(SHAPES[shape]) if smoke else SHAPES[shape]
    try:
        mesh = make_production_mesh(multi_pod=MESHES[mesh_name])
        chips = mesh.size()
        t0 = time.perf_counter()
        fn, args = build_cell(cfg, mesh, shape, device="meta", cell=cell)
        args_bytes = local_bytes(args)
        t_build = time.perf_counter() - t0
        t0 = time.perf_counter()
        tracker, counter = _trace(fn, args, keep_ops)
        t_trace = time.perf_counter() - t0
        summary = counter.summary()
        memory = {"argument_size_in_bytes": args_bytes,
                  "temp_size_in_bytes": tracker.peak - args_bytes,
                  "per_device_total_bytes": tracker.peak,
                  "device_types": sorted(tracker.devices)}
        rec.update(
            status="ok",
            chips=int(chips),
            cuda_initialized=torch.cuda.is_initialized(),
            seconds={"build": round(t_build, 2),
                     "trace": round(t_trace, 2)},
            memory=memory,
            cost={"flops": summary.dot_flops,
                  "bytes accessed": summary.traffic_bytes},
            hlo=summary.to_json(),
            tokens=cell.global_batch * (cell.seq_len
                                        if cell.kind != "decode" else 1),
            model={"params": cfg.num_params(),
                   "active_params": cfg.num_active_params_per_token(),
                   "seq_len": cell.seq_len,
                   "global_batch": cell.global_batch,
                   "kind": cell.kind},
        )
        print(f"[ok]     {arch} × {shape} × {mesh_name}: "
              f"{memory['per_device_total_bytes'] / 2**30:.2f} GiB/dev "
              f"(arguments {args_bytes / 2**30:.2f}), build {t_build:.1f}s"
              f" trace {t_trace:.1f}s; {summary.dot_flops:.3e} FLOPs, "
              f"{summary.traffic_bytes:.3e} B traffic, "
              f"{summary.collective_bytes:.3e} B collectives a rank")
        if keep_ops:
            (out_dir / f"{arch}__{shape}__{mesh_name}.ops.txt").write_text(
                "\n".join(counter.lines) + "\n")
    except Exception as e:  # a failing cell is a bug — record it loudly
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-4000:])
        print(f"[ERROR]  {arch} × {shape} × {mesh_name}: {e}")
    out_path.write_text(json.dumps(rec, indent=1))
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced configs on cells cut by smoke_cell")
    ap.add_argument("--keep-ops", action="store_true",
                    help="write one line per counted op beside each JSON")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    archs = ARCHS if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    n_err = 0
    for mesh_name in meshes:
        with fake_world(WORLD[mesh_name]):
            for arch in archs:
                for shape in shapes:
                    rec = run_cell(arch, shape, mesh_name, out_dir,
                                   force=args.force, smoke=args.smoke,
                                   keep_ops=args.keep_ops)
                    n_err += rec["status"] == "error"
    if n_err:
        print(f"{n_err} cell(s) failed")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
