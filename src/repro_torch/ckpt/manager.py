"""Fault-tolerant checkpoints: atomic, content-verified, asynchronous, in the
reference's on-disk format (``repro/ckpt/manager.py``), so a checkpoint
written by either package restores in the other.

Layout (one directory per step):
    <dir>/step_0000001230/
        manifest.json      — step, wall time, ``extra``, and per leaf its
                             key, file, shape, dtype name and CRC32
        leaf_00000.npy ... — one file per leaf: its raw bytes as a flat
                             uint8 array
    <dir>/LATEST           — the name of the newest complete step directory

A tree is nested dicts (keys in sorted order, as ``jax.tree`` orders a
dict), tuples and lists (in order) of tensors, numpy arrays or Python
numbers; each leaf's key is the path in ``jax.tree_util.keystr``'s form
(``[0]['blocks']['attn']['wq']``), its dtype numpy's name
(``bfloat16``, ``float32``, ``int32``, ...).

Guarantees, as in the reference:
  - Atomicity: leaves go to ``<dir>/.tmp_step_X_<pid>``, renamed into place
    after the manifest is synced, so a crash mid-save never corrupts an
    earlier checkpoint; a stale ``.tmp`` directory is ignored and removed.
  - Integrity: each leaf's CRC32 is verified on restore.
  - Async: ``save_async`` copies the tree to host memory at once and writes
    the files on a background thread; ``wait()`` joins it.
  - Retention: the ``keep`` newest checkpoints are kept.
  - Elasticity: a ``dist.sharding.Sharded`` leaf is saved gathered, so
    its files are byte for byte a one-device save of the same values;
    ``restore(..., shardings=)`` re-shards each leaf onto whatever mesh
    and specs the restoring run gives (a checkpoint saved on a 2x2 mesh
    restores onto 1x1, 1x4 or (2, 2, 2)).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
import zlib
from pathlib import Path

import numpy as np
import torch

from repro_torch.dist import collectives
from repro_torch.dist.sharding import Sharded

# numpy's dtype names of the tensors a checkpoint holds
_NAMES = {torch.float32: "float32", torch.float64: "float64",
          torch.float16: "float16", torch.bfloat16: "bfloat16",
          torch.int64: "int64", torch.int32: "int32", torch.int16: "int16",
          torch.int8: "int8", torch.uint8: "uint8", torch.bool: "bool"}
_DTYPES = {name: dt for dt, name in _NAMES.items()}


def _flatten(tree, path: str = "") -> list[tuple[str, object]]:
    """(key string, leaf) pairs in ``jax.tree``'s order."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, (tuple, list)):
        return [kv for i, t in enumerate(tree)
                for kv in _flatten(t, f"{path}[{i}]")]
    return [(path, tree)]


def _unflatten(tree, leaves: list):
    it = iter(leaves)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        if isinstance(t, (tuple, list)):
            return type(t)(walk(x) for x in t)
        return next(it)
    return walk(tree)


def _host(leaf) -> tuple[np.ndarray, tuple[int, ...], str]:
    """A leaf's raw bytes (flat uint8), shape and dtype name (a sharded
    leaf gathered whole)."""
    if isinstance(leaf, Sharded):
        leaf = collectives.all_gather(leaf, None, torch.device("cpu"))
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu").contiguous()
        raw = t.reshape(-1).view(torch.uint8).numpy() if t.numel() else \
            np.zeros(0, np.uint8)
        return raw, tuple(t.shape), _NAMES[t.dtype]
    arr = np.ascontiguousarray(np.asarray(leaf))
    return arr.view(np.uint8).reshape(-1), arr.shape, str(arr.dtype)


def save(directory: str | os.PathLike, step: int, tree, *,
         extra: dict | None = None) -> Path:
    """A synchronous, atomic checkpoint of ``tree`` at ``step``.  Returns the
    step's directory."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"step_{step:010d}"
    tmp = directory / f".tmp_step_{step:010d}_{os.getpid()}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {"step": int(step), "time": time.time(),
                "extra": extra or {}, "leaves": []}
    for i, (key, leaf) in enumerate(_flatten(tree)):
        raw, shape, dtype = _host(leaf)
        fname = f"leaf_{i:05d}.npy"
        np.save(tmp / fname, raw)
        manifest["leaves"].append({
            "key": key, "file": fname, "shape": list(shape), "dtype": dtype,
            "crc32": zlib.crc32(raw) & 0xFFFFFFFF})
    with open(tmp / "manifest.json", "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    _update_latest(directory, final.name)
    return final


def _update_latest(directory: Path, name: str) -> None:
    tmp = directory / ".LATEST.tmp"
    tmp.write_text(name)
    os.replace(tmp, directory / "LATEST")


def latest_step(directory: str | os.PathLike) -> int | None:
    """The newest complete checkpoint's step: ``LATEST``'s, else (a pointer
    lost in a crash) the largest ``step_*`` directory with a manifest."""
    directory = Path(directory)
    ptr = directory / "LATEST"
    if ptr.exists():
        name = ptr.read_text().strip()
        if (directory / name / "manifest.json").exists():
            return int(name.split("_")[-1])
    steps = sorted(int(p.name.split("_")[-1])
                   for p in directory.glob("step_*")
                   if (p / "manifest.json").exists())
    return steps[-1] if steps else None


def restore(directory: str | os.PathLike, target_tree, *,
            step: int | None = None, shardings=None, verify: bool = True):
    """The checkpoint at ``step`` (default the latest) in the structure of
    ``target_tree``: each leaf checked against its CRC32 and the target's
    shape, and returned as a tensor of the target leaf's dtype on its
    device.  ``shardings``: a tree like the target's of
    ``dist.sharding.NamedSharding`` (or None leaves) to re-shard each leaf
    onto on load, the elastic restart onto another mesh; where it is
    None, a ``Sharded`` target leaf takes its own sharding.  Returns
    (tree, manifest)."""
    directory = Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    path = directory / f"step_{step:010d}"
    manifest = json.loads((path / "manifest.json").read_text())
    targets = [leaf for _, leaf in _flatten(target_tree)]
    if len(targets) != len(manifest["leaves"]):
        raise ValueError(
            f"checkpoint has {len(manifest['leaves'])} leaves, target "
            f"expects {len(targets)} — structure mismatch")
    shards = [sh for _, sh in _flatten(shardings)] if shardings is not None \
        else [None] * len(targets)
    out = []
    for meta, target, sh in zip(manifest["leaves"], targets, shards):
        raw = np.load(path / meta["file"])
        if verify and zlib.crc32(raw) & 0xFFFFFFFF != meta["crc32"]:
            raise IOError(f"CRC mismatch for {meta['key']} in {path}")
        shape = tuple(meta["shape"])
        if shape != tuple(target.shape):
            raise ValueError(f"shape mismatch for {meta['key']}: "
                             f"{shape} vs {tuple(target.shape)}")
        t = torch.from_numpy(raw).view(_DTYPES[meta["dtype"]]).reshape(shape)
        dt = target.dtype if isinstance(target, (torch.Tensor, Sharded)) \
            else t.dtype
        if sh is None and isinstance(target, Sharded):
            sh = target.sharding
        if sh is not None:
            out.append(collectives.scatter(t.to(dt), sh))
            continue
        dev = target.device if isinstance(target, torch.Tensor) else "cpu"
        out.append(t.to(device=dev, dtype=dt))
    return _unflatten(target_tree, out), manifest


def gc_tmp(directory: str | os.PathLike) -> None:
    """Remove the ``.tmp`` directories that crashed saves left behind."""
    for p in Path(directory).glob(".tmp_step_*"):
        shutil.rmtree(p, ignore_errors=True)


class CheckpointManager:
    """Keep-N retention, asynchronous saves and resume."""

    def __init__(self, directory: str | os.PathLike, keep: int = 3,
                 save_interval: int = 100):
        self.directory = Path(directory)
        self.keep = keep
        self.save_interval = save_interval
        self._thread: threading.Thread | None = None
        self.directory.mkdir(parents=True, exist_ok=True)
        gc_tmp(self.directory)

    def should_save(self, step: int) -> bool:
        return step > 0 and step % self.save_interval == 0

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save_async(self, step: int, tree, extra: dict | None = None) -> None:
        """Copy ``tree`` to host memory now (so the caller may go on
        updating it in place) and write the files on a background
        thread."""
        self.wait()
        host = _unflatten(tree, [
            collectives.all_gather(leaf, None, torch.device("cpu"))
            if isinstance(leaf, Sharded) else
            leaf.detach().to("cpu", copy=True)
            if isinstance(leaf, torch.Tensor) else np.array(leaf)
            for _, leaf in _flatten(tree)])

        def work():
            save(self.directory, step, host, extra=extra)
            self._retain()
        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def save_sync(self, step: int, tree, extra: dict | None = None) -> None:
        self.wait()
        save(self.directory, step, tree, extra=extra)
        self._retain()

    def _retain(self) -> None:
        steps = sorted(int(p.name.split("_")[-1])
                       for p in self.directory.glob("step_*"))
        for s in steps[:-self.keep]:
            shutil.rmtree(self.directory / f"step_{s:010d}",
                          ignore_errors=True)

    def restore_latest(self, target_tree, shardings=None):
        return restore(self.directory, target_tree, shardings=shardings)
