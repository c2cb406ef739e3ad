"""Dry run on the production meshes: per-device memory, FLOPs and
collective bytes of every (arch × shape) cell, for ``analysis.roofline``.

The port of ``repro.launch.dryrun``.  JAX lowers and compiles each cell on
512 fake XLA devices; the port has no compiler to ask, so each cell runs
its sharded step once, as rank 0 of a ``fake`` process group of 256 or
512 ranks (no communication happens), on ``meta`` tensors (nothing is
allocated or computed), and counts what that rank does:

* ``cost["flops"]`` — ``torch.utils.flop_counter.FlopCounterMode`` over
  the rank's local tensors: per-device FLOPs (matrix products), the
  figure ``roofline.analyze`` multiplies by the chip count.  (Counted
  around DTensor ops it would be the global product.)
* ``cost["bytes accessed"]`` — the sum, over every op the rank runs, of
  its tensor inputs' and outputs' bytes (views, which move nothing,
  excluded); the port's kernels are ops too (``repro_torch::topk``,
  ``repro_torch::embedding_bag_fixed``, whose fake implementations give
  their outputs on ``meta`` tensors), and ``kernel_calls`` counts their
  calls.  The record's ``cost_definitions`` says so.
* ``collectives`` — each collective's local result bytes by kind
  (``distributed.spmd.CollectiveLog``; a reduce-scatter's scaled by its
  group size, as ``repro.analysis.hlo`` counts XLA's), ``count`` and
  ``total``.
* ``memory`` — ``argument_bytes``: the rank's blocks of the parameters
  and inputs (``param_bytes`` of them the parameters); ``output_bytes``;
  ``peak_bytes``: the peak of the rank's live tensors over the step
  (``torch.distributed._tools.mem_tracker.MemTracker``; the step cuts
  its argument blocks itself, so they are counted); ``temp_bytes``: that
  peak less ``argument_bytes``.

Run it in its own process (it starts the fake group)::

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        [--arch A]... [--shape S]... [--cell A:S]... \\
        [--mesh single|multi|both] \\
        [--out experiments/dryrun] [--devices-per-pod 256] [--smoke]

Cells whose shape has a ``skip_reason`` are written as JAX writes them.
A ``train`` cell's arguments are the model, the optimizer state's blocks
(``bundle.init_opt`` on ``meta``) and the batch, and every figure covers
the forward, the backward and the update (``memory["opt_state_bytes"]``
the state's blocks; ``kernel_calls`` counts B3 and B3-bwd,
``repro_torch::embedding_bag_fixed_backward``).  JAX's ``--probe-scan``
has no counterpart: XLA
counts a scan body once whatever its trip count, so JAX compiles one- and
two-layer probes to correct it; the port runs its layer loop eagerly, so
every layer is counted.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

BYTES_DEFINITION = ("sum over every op run on this rank (aten's and the "
                    "port's kernels, repro_torch::*) of its tensor inputs' "
                    "and outputs' bytes (views excluded); meta tensors, "
                    "nothing executed")
FLOPS_DEFINITION = ("FlopCounterMode over this rank's local tensors: "
                    "per-device FLOPs of the matrix products")
PEAK_DEFINITION = ("MemTracker's peak over the step on this rank, which "
                   "cuts its argument blocks itself (meta blocks of their "
                   "own size); temp_bytes is that peak less argument_bytes")


def _fake_group(n: int) -> None:
    """A ``fake`` default group of n ranks, this process rank 0."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def _mesh_for(name: str, devices_per_pod: int = 256):
    """(data, model) = (devices_per_pod / 16, 16), or (2, data, model) for
    ``"multi"``, over a fake group of that many ranks: (16, 16) and
    (2, 16, 16) by default."""
    from torch.distributed.device_mesh import init_device_mesh

    if name == "multi":
        shape = (2, devices_per_pod // 16, 16)
        names = ("pod", "data", "model")
    else:
        shape = (devices_per_pod // 16, 16)
        names = ("data", "model")
    n = 1
    for s in shape:
        n *= s
    _fake_group(n)
    return init_device_mesh("cpu", shape, mesh_dim_names=names)


def _meta_tree(spec):
    """A tree of :class:`TensorSpec` as empty ``meta`` tensors."""
    import torch

    from repro_torch.launch.api import TensorSpec

    if isinstance(spec, TensorSpec):
        return torch.empty(spec.shape, dtype=spec.dtype, device="meta")
    if isinstance(spec, dict):
        return {k: _meta_tree(v) for k, v in spec.items()}
    return type(spec)(*(_meta_tree(v) for v in spec))


def _leaves(tree):
    import torch

    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return []


def _nbytes(t) -> int:
    from repro_torch.distributed import sharding as SH

    t = SH.local(t)
    return t.numel() * t.element_size()


def _local_bytes(shape, dtype_size: int, spec, mesh) -> int:
    from repro_torch.distributed import sharding as SH

    n = dtype_size
    for lo, hi in SH.local_bounds(shape, spec, mesh):
        n *= hi - lo
    return n


def param_specs(arch, cfg, mesh, shape=None):
    """The model's parameters by name, each with its spec on ``mesh``
    (JAX's ``param_partition_specs`` for an LM, the recsys step's table
    specs, the rest replicated; GatedGCN's at ``shape``'s widths)."""
    from repro_torch.launch.mesh import data_axes_of

    if arch.family == "lm":
        from repro_torch.distributed.sharding import LMSharding
        from repro_torch.models import transformer as tfm

        fsdp = cfg.moe is not None
        shd = LMSharding(data_axes=data_axes_of(mesh), fsdp_experts=fsdp)
        specs = tfm.param_partition_specs(cfg, shd)
        model = tfm.Transformer(cfg, device="meta")
        out = {}
        for name, p in model.named_parameters():
            top, _, leaf = name.partition(".")
            out[name] = (p, specs[top][leaf] if leaf else specs[top])
        return model, out
    if arch.family == "recsys":
        from repro_torch.launch.steps import MODELS
        from repro_torch.models import recsys as rec_lib

        model = MODELS[arch.name](cfg, device="meta")
        tables = rec_lib.SHARDED_TABLES[arch.name]
        specs = rec_lib.table_specs(model, arch.name)
        return model, {n: (p, specs[n]) for n, p in model.named_parameters()}
    if arch.family == "gnn":
        from repro_torch.configs.gatedgcn import shape_config
        from repro_torch.models.gnn import GatedGCN

        model = GatedGCN(shape_config(cfg, shape), device="meta")
        return model, {n: (p, ()) for n, p in model.named_parameters()}
    return None, {}


def _byte_count():
    """A dispatch mode whose ``total`` sums each op's tensor input and
    output bytes (views excluded) and whose ``kernels`` counts the calls
    of the port's kernels (``repro_torch::*`` ops)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class ByteCount(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.total = 0
            self.kernels = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not getattr(func, "is_view", False):
                self.total += sum(_plain_bytes(t) for t in
                                  _leaves((args, kwargs or {}, out)))
            if func.namespace == "repro_torch":
                name = func.overloadpacket.__name__
                self.kernels[name] = self.kernels.get(name, 0) + 1
            return out

    return ByteCount()


def _plain_bytes(t) -> int:
    return t.numel() * t.element_size()


def _step_args(arch, bundle, model, shape):
    """The step's arguments: the model, then meta tensors of the specs
    (a decode's position is the cache's last slot; a train step's
    optimizer state is its blocks, from ``bundle.init_opt``)."""
    from repro_torch.launch.api import TensorSpec

    specs = bundle.arg_specs
    if arch.family == "eval":
        return [_meta_tree(specs[0])]
    args = [model]
    for spec in specs[1:]:
        if isinstance(spec, TensorSpec) and spec.shape == ():
            args.append(shape.get("seq_len") - 1)
        else:
            args.append(_meta_tree(spec))
    if shape.kind == "train":  # the optimizer state's blocks
        args[1] = bundle.init_opt(model)
    return args


def run_cell(arch_name: str, shape_name: str, mesh_name: str,
             devices_per_pod: int = 256, smoke: bool = False) -> dict:
    """One cell's record."""
    import torch
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.distributed import spmd
    from repro_torch.launch.api import get_arch
    from repro_torch.launch.mesh import mesh_shape

    arch = get_arch(arch_name)
    shape = arch.shapes[shape_name]
    rec = {"arch": arch_name, "shape": shape_name, "mesh": mesh_name,
           "family": arch.family, "status": "ok"}
    if shape.skip_reason:
        rec["status"] = "skipped"
        rec["skip_reason"] = shape.skip_reason
        return rec
    mesh = _mesh_for(mesh_name, devices_per_pod)
    rec["mesh_shape"] = mesh_shape(mesh)
    rec["n_chips"] = int(mesh.size())
    cfg = arch.make_config(smoke)
    t0 = time.time()
    try:
        bundle = arch.make_step(cfg, shape, device="meta", mesh=mesh)
        model, params = param_specs(arch, cfg, mesh, shape)
        args = _step_args(arch, bundle, model, shape)
        param_bytes = sum(_local_bytes(p.shape, p.element_size(), spec, mesh)
                          for p, spec in params.values())
        rec["lower_s"] = round(time.time() - t0, 2)
        counter = _byte_count()
        tracker = MemTracker()
        flops = FlopCounterMode(display=False)
        t1 = time.time()
        with spmd.collective_log() as log, spmd.input_log() as inputs:
            with tracker, flops, counter:
                out = bundle.step_fn(*args)
        rec["compile_s"] = round(time.time() - t1, 2)
        snap = tracker.get_tracker_snapshot("peak")
        peak = max((v.get("Total", 0) for v in snap.values()), default=0)
        # each input's block as the step cut it (a replicated one whole)
        arg_bytes = param_bytes + sum(inputs.get(id(t), _plain_bytes(t))
                                      for t in _leaves(args))
        rec["memory"] = {
            "argument_bytes": int(arg_bytes),
            "param_bytes": int(param_bytes),
            "opt_state_bytes": int(sum(_plain_bytes(t) for t in
                                       _leaves(args[1]))
                                   if shape.kind == "train" else 0),
            "output_bytes": int(sum(_nbytes(t) for t in _leaves(out)
                                    if id(t) not in inputs)),
            "temp_bytes": int(max(peak - arg_bytes, 0)),
            # an output that is an input (a decode's cache, written in
            # place: JAX donates it)
            "alias_bytes": int(sum(inputs[id(t)] for t in _leaves(out)
                                   if id(t) in inputs)),
            "peak_bytes": int(max(peak, arg_bytes)),
        }
        rec["cost"] = {"flops": float(flops.get_total_flops()),
                       "bytes accessed": float(counter.total)}
        rec["cost_definitions"] = {"flops": FLOPS_DEFINITION,
                                   "bytes accessed": BYTES_DEFINITION,
                                   "peak_bytes": PEAK_DEFINITION}
        rec["collectives"] = log.summary()
        rec["kernel_calls"] = dict(counter.kernels)
        print(f"[{arch_name} × {shape_name} × {mesh_name}] "
              f"flops/dev={rec['cost']['flops']:.3e} "
              f"bytes/dev={rec['cost']['bytes accessed']:.3e} "
              f"collective/dev={rec['collectives']['total']:.3e} "
              f"peak/dev={rec['memory']['peak_bytes']:.3e}", flush=True)
    except Exception as e:  # noqa: BLE001 — a failed cell is a bug report
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    rec["total_s"] = round(time.time() - t0, 2)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.dryrun",
        description="Per-device FLOPs, bytes, collective bytes and memory "
                    "of each (arch x shape) cell on the production meshes, "
                    "as rank 0 of a fake process group on meta tensors.")
    ap.add_argument("--arch", action="append", default=None)
    ap.add_argument("--shape", action="append", default=None)
    ap.add_argument("--cell", action="append", default=None,
                    metavar="ARCH:SHAPE",
                    help="run these cells only (instead of --arch x --shape)")
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="both")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--devices-per-pod", type=int, default=256)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced configs (CI mini dry run)")
    args = ap.parse_args(argv)

    from repro_torch.launch.api import get_arch, list_archs

    meshes = ("single", "multi") if args.mesh == "both" else (args.mesh,)
    if args.cell:
        cells = [tuple(c.split(":", 1)) for c in args.cell]
    else:
        cells = []
        for arch_name in args.arch or list_archs():
            arch = get_arch(arch_name)
            cells += [(arch_name, s) for s in args.shape or list(arch.shapes)
                      if s in arch.shapes]
    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for arch_name, shape_name in cells:
        for mesh_name in meshes:
            tag = f"{arch_name}__{shape_name}__{mesh_name}"
            rec = run_cell(arch_name, shape_name, mesh_name,
                           args.devices_per_pod, args.smoke)
            with open(os.path.join(args.out, tag + ".json"), "w") as fh:
                json.dump(rec, fh, indent=1)
            status = rec["status"]
            extra = (f" ({rec.get('total_s', 0):.1f}s)"
                     if status == "ok" else
                     f" — {rec.get('skip_reason', rec.get('error', ''))}")
            print(f"{tag}: {status}{extra}", flush=True)
            failures += status == "error"
    print(f"dry-run complete; {failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
