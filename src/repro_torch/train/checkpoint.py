"""Checkpoints with atomic commit and async save: the port of
``repro.train.checkpoint``, in the JAX package's on-disk layout.

``<dir>/step_%08d/`` holds ``arrays.npz`` (one ``leaf_%05d`` per leaf, in
``jax.tree.leaves`` order of the same tree in the JAX package),
``manifest.json`` (step, a description of the tree, the leaf count, the
caller's ``extra``) and a ``.COMMIT`` marker written last.  Arrays are
written to ``step_%08d.tmp`` and renamed, so a preempted save is never
mistaken for a valid checkpoint, and ``latest_step`` sees only committed
steps.  A checkpoint written by either package restores into the other
for float32 and int32 leaves.

Trees are nested dicts, tuples and named tuples (``OptState``) of
tensors, and ``nn.Module``s: a module's leaves are its parameters, in JAX
leaf order of their dotted names (``optimizer.leaf_order``), as are a
dict's keys, so ``{"params": model, "opt_state": OptState(step, m, v)}``
flattens as JAX's ``{"params": ..., "opt_state": OptState(step, [m],
[v])}`` does.

bfloat16 leaves are stored as their 16 bits (``|V2``), the bytes JAX
writes through ``ml_dtypes``, and read back as bits, so a JAX-written
bfloat16 leaf restores here exactly.  (The JAX package's own ``restore``
cannot read bfloat16 leaves back: numpy has no cast from ``|V2``.)

``AsyncCheckpointer`` copies the tree to host memory synchronously and
writes it on a background thread; an error there is raised by the next
``wait`` or ``save``.

Sharded state (a model-parallel train step's).  A leaf may be a DTensor
and a tree may hold a ``sharding.ShardedParams`` (its blocks, as
DTensors); ``optimizer.state_dtensors`` lays out an optimizer state so.
Every rank calls :func:`save` (or ``AsyncCheckpointer.save``): each
DTensor is gathered into its logical array (``sharding.full_tensor``,
JAX's layout) and rank 0 of the default group writes.  :func:`restore`
into such a target cuts each stored array by the target's own mesh and
spec (``sharding.local_shard``), so a state saved under one mesh
restores under any other, or under none.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.distributed import sharding as SH
from repro_torch.train.optimizer import leaf_order

_BF16_BITS = np.dtype("V2")


def _named_leaves(tree, path: str = "") -> List[Tuple[str, Any]]:
    """(dotted path, leaf) pairs in JAX leaf order."""
    def join(key):
        return f"{path}.{key}" if path else str(key)

    if isinstance(tree, nn.Module):
        tree = dict(tree.named_parameters())
    if isinstance(tree, SH.ShardedParams):
        tree = tree.dtensors()
    if isinstance(tree, Mapping):
        return [pair for k in leaf_order(tree)
                for pair in _named_leaves(tree[k], join(k))]
    if isinstance(tree, (tuple, list)):
        return [pair for i, v in enumerate(tree)
                for pair in _named_leaves(v, join(i))]
    return [(path, tree)]


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = SH.full_tensor(x).detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(_BF16_BITS)
        return x.numpy()
    return np.asarray(x)


def _from_numpy(arr: np.ndarray, ref) -> torch.Tensor:
    """The stored array as a tensor of ``ref``'s dtype on its device
    (a ``meta`` or spec reference: the CPU)."""
    if arr.dtype == _BF16_BITS:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    dev = getattr(SH.local(ref), "device", None)
    if dev is None or dev.type == "meta":
        dev = torch.device("cpu")
    return t.to(device=dev, dtype=ref.dtype)


def _snapshot(tree) -> List[Tuple[str, np.ndarray]]:
    return [(p, _to_numpy(x)) for p, x in _named_leaves(tree)]


def _write(ckpt_dir: str, step: int, flat, extra: Optional[dict]) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"),
             **{f"leaf_{i:05d}": a for i, (_, a) in enumerate(flat)})
    manifest = {"step": step, "treedef": " ".join(p for p, _ in flat),
                "n_leaves": len(flat), "extra": extra or {}}
    with open(os.path.join(tmp, "manifest.json"), "w") as fh:
        json.dump(manifest, fh)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    # commit marker last: a crash before this line leaves no valid ckpt
    with open(os.path.join(final, ".COMMIT"), "w") as fh:
        fh.write("ok\n")
    return final


def _writer() -> bool:
    """Whether this process writes: rank 0 of the default group, or the
    only process."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def save(ckpt_dir: str, step: int, tree, extra: Optional[dict] = None) -> str:
    """Synchronous atomic save.  Returns the committed directory.  Under a
    process group every rank calls it (each DTensor is gathered); rank 0
    writes, and every rank returns once it has."""
    flat = _snapshot(tree)
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    if _writer():
        path = _write(ckpt_dir, step, flat, extra)
    import torch.distributed as dist

    if dist.is_initialized():
        dist.barrier()
    return path


def _committed_steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(
        int(n[5:]) for n in os.listdir(ckpt_dir)
        if n.startswith("step_") and not n.endswith(".tmp")
        and os.path.exists(os.path.join(ckpt_dir, n, ".COMMIT")))


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = _committed_steps(ckpt_dir)
    return steps[-1] if steps else None


def _rebuild(tree, path: str, flat: dict):
    def join(key):
        return f"{path}.{key}" if path else str(key)

    if isinstance(tree, nn.Module):  # restored into its parameters
        with torch.no_grad():
            for n, p in tree.named_parameters():
                p.copy_(flat[join(n)])
        return tree
    if isinstance(tree, SH.ShardedParams):  # into its blocks
        with torch.no_grad():
            for n, p in tree.items():
                p.copy_(SH.local_shard(flat[join(n)], tree.specs[n],
                                       tree.mesh))
        return tree
    if hasattr(tree, "to_local"):  # a DTensor: this rank's block of it
        spec = SH.spec_of(tree)
        block = SH.local_shard(flat[path], spec, tree.device_mesh)
        return SH.from_local(block.contiguous(), spec, tree.device_mesh,
                             tree.shape)
    if isinstance(tree, Mapping):
        return {k: _rebuild(v, join(k), flat) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(v, join(i), flat)
                            for i, v in enumerate(tree)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(v, join(i), flat)
                          for i, v in enumerate(tree))
    return flat[path]


def restore(ckpt_dir: str, step: int, target) -> Tuple[Any, dict]:
    """Restore into the structure of ``target`` (shapes validated, dtypes
    and devices taken from it; leaves may be tensors or
    ``launch.api.TensorSpec``s).  A module in ``target`` gets the stored
    values in its own parameters.  Returns (tree, extra)."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    if not os.path.exists(os.path.join(path, ".COMMIT")):
        raise FileNotFoundError(f"no committed checkpoint at {path}")
    with open(os.path.join(path, "manifest.json")) as fh:
        manifest = json.load(fh)
    leaves = _named_leaves(target)
    if len(leaves) != manifest["n_leaves"]:
        raise ValueError(
            f"checkpoint has {manifest['n_leaves']} leaves, target expects "
            f"{len(leaves)}")
    flat = {}
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for i, (name, ref) in enumerate(leaves):
            arr = data[f"leaf_{i:05d}"]
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(
                    f"leaf {i} ({name}): checkpoint shape {arr.shape} != "
                    f"target {tuple(ref.shape)}")
            flat[name] = _from_numpy(arr, ref)
    return _rebuild(target, "", flat), manifest["extra"]


def garbage_collect(ckpt_dir: str, keep: int = 3) -> None:
    steps = _committed_steps(ckpt_dir)
    for s in steps[:-keep] if keep else steps:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"))


class AsyncCheckpointer:
    """Snapshot synchronously, persist on a background thread."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.last_committed: Optional[int] = None

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, tree, extra: Optional[dict] = None) -> None:
        """Under a process group every rank calls it (each DTensor is
        gathered); rank 0 alone writes and keeps ``last_committed``."""
        self.wait()  # one in-flight save at a time
        flat = _snapshot(tree)
        if not _writer():
            return

        def _persist():
            try:
                _write(self.ckpt_dir, step, flat, extra)
                garbage_collect(self.ckpt_dir, self.keep)
                self.last_committed = step
            except BaseException as e:  # raised again by wait()
                self._error = e

        self._thread = threading.Thread(target=_persist, daemon=True)
        self._thread.start()
