"""Sharded, asynchronous, atomic checkpointing.

- **Sharded**: each process writes only the leaves it owns (files and
  manifest are tagged with its process index: the ``torch.distributed``
  rank when a process group is up, else 0); the manifest records the
  tree structure + leaf shapes/dtypes so restore can place the global
  arrays on a *different* machine (elastic restart).
- **Async**: ``save()`` snapshots the leaves to host memory synchronously
  (a device tensor is copied to the host with an explicit ``.cpu()``) and
  writes to disk on a background thread.
- **Atomic**: writes land in ``step_<N>.tmp/`` and a single ``rename()``
  commits; a crash mid-write leaves the previous checkpoint intact. Restore
  picks the newest committed step.
- **Sparse-aware**: :class:`SparseCheckpoint` layers the compressed-tree
  snapshot (pos/crd/vals per level) and per-tensor content fingerprints on
  top, so elastic recovery restores only what changed and skips
  re-partitioning unchanged operands.

Leaves are named and ordered as the JAX package names and orders them
(``jax.tree_util``: dict keys sorted, list and tuple entries by index,
``None`` an empty subtree), so the same state gives the same manifest.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


def _children(tree) -> Optional[List[Tuple[Any, Any]]]:
    """(path key, child) pairs of a container node, or None for a leaf:
    dict entries in sorted key order, namedtuple fields by name, list and
    tuple entries by index."""
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def _flatten(tree, path=()) -> List[Tuple[Tuple, Any]]:
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(path, tree)]
    out = []
    for key, child in kids:
        out += _flatten(child, path + (key,))
    return out


def _unflatten(like, leaves) -> Any:
    """``like``'s structure with its leaves replaced, in flatten order, by
    the next items of the iterator ``leaves``."""
    if like is None:
        return None
    kids = _children(like)
    if kids is None:
        return next(leaves)
    if isinstance(like, dict):
        return {k: _unflatten(v, leaves) for k, v in kids}
    vals = [_unflatten(v, leaves) for _, v in kids]
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*vals)
    return type(like)(vals)


def _treedef(tree) -> str:
    """The tree's structure as text (leaves as ``*``), for the manifest."""
    if tree is None:
        return "None"
    kids = _children(tree)
    if kids is None:
        return "*"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef(v)}" for k, v in kids) + "}"
    inner = ", ".join(_treedef(v) for _, v in kids)
    if isinstance(tree, list):
        return f"[{inner}]"
    return f"({inner}{',' if len(kids) == 1 else ''})"


def _flatten_with_names(tree) -> List[Tuple[str, Any]]:
    out = []
    seen: Dict[str, int] = {}
    for path, leaf in _flatten(tree):
        name = "/".join(str(p) for p in path) or "leaf"
        # "/"-joined paths can collide (e.g. {"a": {"b": _}, "a/b": _});
        # manifests are keyed positionally but the names must still be
        # unambiguous for humans and for name-addressed partial restores.
        if name in seen:
            seen[name] += 1
            name = f"{name}#{seen[name]}"
        else:
            seen[name] = 0
        out.append((name, leaf))
    return out


def _host(leaf) -> np.ndarray:
    """A leaf as a host array: tensors (on any device) are copied to the
    host explicitly; ``np.asarray`` of a CUDA tensor would raise."""
    if torch.is_tensor(leaf):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _process_index() -> int:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3,
                 process_index: Optional[int] = None):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.proc = (process_index if process_index is not None
                     else _process_index())
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------------
    def save(self, step: int, state: Dict[str, Any], *,
             blocking: bool = False) -> None:
        """Snapshot ``state`` (a tree of arrays, tensors and scalars) at
        ``step``."""
        self.wait()  # one in-flight checkpoint at a time
        # synchronous device→host snapshot (consistent view)
        host_leaves = [(n, _host(l)) for n, l in _flatten_with_names(state)]
        treedef = _treedef(state)

        def write():
            try:
                tmp = self.dir / f"step_{step:08d}.tmp"
                final = self.dir / f"step_{step:08d}"
                if tmp.exists():
                    shutil.rmtree(tmp)
                tmp.mkdir(parents=True)
                manifest = {"step": step, "proc": self.proc, "leaves": []}
                for i, (name, arr) in enumerate(host_leaves):
                    fn = f"leaf_{i:05d}_p{self.proc}.npy"
                    np.save(tmp / fn, arr)
                    manifest["leaves"].append(
                        {"name": name, "file": fn,
                         "shape": list(arr.shape), "dtype": str(arr.dtype)})
                manifest["treedef"] = treedef
                (tmp / f"manifest_p{self.proc}.json").write_text(
                    json.dumps(manifest))
                os.replace(tmp, final)  # atomic commit
                self._gc()
            except BaseException as e:  # noqa: BLE001
                self._error = e

        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f"async checkpoint failed: {err!r}")

    # ------------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        steps = sorted(int(p.name.split("_")[1]) for p in self.dir.glob(
            "step_*") if not p.name.endswith(".tmp"))
        return steps[-1] if steps else None

    def restore(self, like: Dict[str, Any],
                step: Optional[int] = None) -> Tuple[int, Dict[str, Any]]:
        """Restore into the structure of ``like``. The leaves come back as
        host arrays; the caller places them on its device (shapes are
        global, so any machine works: elastic restart)."""
        self._sweep_orphans()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        d = self.dir / f"step_{step:08d}"
        manifest = json.loads((d / f"manifest_p{self.proc}.json").read_text())
        leaves = [np.load(d / leaf["file"]) for leaf in manifest["leaves"]]
        return step, _unflatten(like, iter(leaves))

    def _sweep_orphans(self) -> None:
        """Remove ``step_<N>.tmp/`` directories left by a crash mid-write.
        They never commit (os.replace is the commit point) so they are
        garbage — but without this sweep they accumulate forever. Skipped
        while an async save is in flight (its tmp dir is live)."""
        if self._thread is not None and self._thread.is_alive():
            return
        for p in self.dir.glob("step_*.tmp"):
            shutil.rmtree(p, ignore_errors=True)

    def _gc(self) -> None:
        steps = sorted(int(p.name.split("_")[1]) for p in self.dir.glob(
            "step_*") if not p.name.endswith(".tmp"))
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)


# ---------------------------------------------------------------------------
# Sparse checkpointing — compressed trees + content fingerprints
# ---------------------------------------------------------------------------


class SparseCheckpoint:
    """Checkpoint/restore for sparse-kernel run loops.

    Each snapshot holds, per tensor, the full compressed tree (vals plus
    every level's pos/crd) and its content CRC — the same fingerprint that
    keys the shard/plan caches. On restore, tensors whose live CRC already
    matches the snapshot are left untouched (their cache entries stay
    valid → recovery skips re-partitioning them); mismatches are healed in
    place. Arbitrary extra state (accumulators, step counters; tensors on
    any device) goes in ``extra`` and comes back as host arrays.

    The snapshot keeps the reference's ``tuned`` leaf for the autoscheduler's
    tuned-plan cache, which the port does not have yet (ROADMAP Queue 1
    item 7): ``save`` writes it empty and ``restore`` reports
    ``tuned_imported: 0``.
    """

    def __init__(self, directory: str, *, keep: int = 3,
                 process_index: Optional[int] = None):
        self.mgr = CheckpointManager(directory, keep=keep,
                                     process_index=process_index)
        self._last_fp: Dict[str, int] = {}

    # -- snapshot layout ------------------------------------------------
    @staticmethod
    def _leaves(t) -> Dict[str, np.ndarray]:
        out = {"vals": np.asarray(t.vals)}
        for l, ld in enumerate(t.levels):
            if ld.pos is not None:
                out[f"pos{l}"] = np.asarray(ld.pos)
            if ld.crd is not None:
                out[f"crd{l}"] = np.asarray(ld.crd)
        return out

    @staticmethod
    def _crc(t) -> int:
        return int(t.fingerprint()[-1])

    def _like(self, tensors: Dict[str, Any],
              extra_like: Dict[str, Any]) -> Dict[str, Any]:
        return {"extra": extra_like,
                "fp": {n: np.int64(0) for n in tensors},
                "tensors": {n: self._leaves(t) for n, t in tensors.items()},
                "tuned": np.zeros(0, dtype=np.uint8)}

    # -- save / restore -------------------------------------------------
    def save(self, step: int, tensors: Dict[str, Any],
             extra: Optional[Dict[str, Any]] = None, *,
             blocking: bool = True) -> None:
        fps = {n: self._crc(t) for n, t in tensors.items()}
        state = {"extra": dict(extra or {}),
                 "fp": {n: np.int64(c) for n, c in fps.items()},
                 "tensors": {n: self._leaves(t) for n, t in tensors.items()},
                 "tuned": np.zeros(0, dtype=np.uint8)}
        self.mgr.save(step, state, blocking=blocking)
        self._last_fp = fps

    def stale_operands(self, tensors: Dict[str, Any]) -> List[str]:
        """Tensors whose CURRENT content CRC deviates from the last
        committed snapshot — corruption detection through the exact
        fingerprints that key the shard caches."""
        return sorted(n for n, t in tensors.items()
                      if n in self._last_fp
                      and self._crc(t) != self._last_fp[n])

    def restore(self, tensors: Dict[str, Any],
                extra_like: Optional[Dict[str, Any]] = None,
                step: Optional[int] = None,
                ) -> Tuple[int, Dict[str, Any], Dict[str, Any]]:
        """Restore the newest (or given) step. Heals mismatched tensors in
        place, leaves matching ones alone, and returns
        ``(step, extra, info)`` where info counts what was ``reused`` vs
        ``restored`` (plus ``tuned_imported``, 0 in the port)."""
        step, got = self.mgr.restore(
            self._like(tensors, dict(extra_like or {})), step=step)
        reused, restored = [], []
        for n, t in tensors.items():
            saved_crc = int(got["fp"][n])
            if self._crc(t) == saved_crc:
                reused.append(n)
            else:
                self._copy_into(t, got["tensors"][n])
                restored.append(n)
            self._last_fp[n] = saved_crc
        return step, got["extra"], {"reused": reused, "restored": restored,
                                    "tuned_imported": 0}

    def wait(self) -> None:
        self.mgr.wait()

    def latest_step(self) -> Optional[int]:
        return self.mgr.latest_step()

    @staticmethod
    def _copy_into(t, leaves: Dict[str, np.ndarray]) -> None:
        t.vals[...] = leaves["vals"]
        for l, ld in enumerate(t.levels):
            if ld.pos is not None:
                ld.pos[...] = leaves[f"pos{l}"]
            if ld.crd is not None:
                ld.crd[...] = leaves[f"crd{l}"]
