"""Checkpointing: per-shard npz + JSON metadata, async save thread,
keep-last-k retention, atomic rename, resume with re-sharding.

Layout:  <dir>/step_<n>/shard_<i>.npz + meta.json
A checkpoint directory is only considered complete once `COMMIT` exists
AND the directory has been renamed from its `.tmp` staging name — a
crash mid-save never corrupts the restore path (fault tolerance).
Stale `*.tmp` staging dirs (even ones containing `COMMIT`, from a crash
between the commit mark and the rename) are ignored by `all_steps()`
and garbage-collected on startup.

A state is a nested `dict` / `list` / `tuple` of leaves (torch tensors,
numpy arrays, scalars).  Its leaves are keyed as the JAX package keys
the same tree: the path of dict keys (sorted) and sequence indices
joined by "/", `None` holding no leaf — so a directory written by
either package restores in the other.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any

import numpy as np
import torch

__all__ = ["CheckpointManager"]

_STEP_RE = re.compile(r"^step_(\d+)$")


def _leaves(tree, prefix: tuple = ()):
    """(key path, leaf) pairs in the JAX package's flatten order: dict
    keys sorted, sequences in order, `None` an empty subtree."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _leaves(sub, prefix + (str(i),))
    else:
        yield prefix, tree


def _key(path: tuple) -> str:
    return "/".join(str(k) for k in path)


def _to_host(leaf) -> np.ndarray:
    """A host copy of one leaf (a tensor on the card is copied over; a
    CPU tensor is cloned, so later in-place updates cannot reach an
    async save)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        t = t.clone() if t.device.type == "cpu" else t.cpu()
        return t.numpy()
    return np.asarray(leaf)


def _map_tree(fn, tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(fn, v) for v in tree)
    return fn(tree)


def _flatten(tree) -> dict:
    return {_key(path): np.asarray(leaf) for path, leaf in _leaves(tree)}


def _unflatten_like(template, flat: dict):
    """`template`'s structure with its leaves read from `flat`, each in
    the template leaf's dtype (a tensor template gives a tensor on the
    template's device)."""
    def build(tree, prefix):
        if tree is None:
            return None
        if isinstance(tree, dict):
            return {k: build(v, prefix + (k,)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(build(v, prefix + (str(i),))
                              for i, v in enumerate(tree))
        key = _key(prefix)
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = flat[key]
        shape = tuple(tree.shape) if hasattr(tree, "shape") \
            else np.shape(tree)
        if tuple(arr.shape) != shape:
            raise ValueError(
                f"shape mismatch for {key}: ckpt {arr.shape} "
                f"vs expected {shape}")
        if isinstance(tree, torch.Tensor):
            return torch.tensor(arr, dtype=tree.dtype, device=tree.device)
        return arr.astype(np.asarray(tree).dtype)
    return build(template, ())


class CheckpointManager:
    """Save/restore train state with retention + async write."""

    def __init__(self, directory: str, keep: int = 3,
                 shard_id: int = 0, num_shards: int = 1):
        self.dir = directory
        self.keep = keep
        self.shard_id = shard_id
        self.num_shards = num_shards
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._async_exc: BaseException | None = None
        self._gc_stale_tmp()

    def _gc_stale_tmp(self) -> None:
        """Remove `.tmp` staging dirs left by a crash mid-save."""
        for name in os.listdir(self.dir):
            if name.endswith(".tmp") and _STEP_RE.match(name[:-4]):
                shutil.rmtree(os.path.join(self.dir, name),
                              ignore_errors=True)

    # ------------------------------------------------------------------ #
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def all_steps(self) -> list[int]:
        steps = []
        for name in os.listdir(self.dir):
            m = _STEP_RE.match(name)
            if m and os.path.exists(
                    os.path.join(self.dir, name, "COMMIT")):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # ------------------------------------------------------------------ #
    def _write(self, step: int, state: dict, meta: dict) -> None:
        d = self._step_dir(step)
        tmp = d + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        flat = _flatten(state)
        np.savez_compressed(
            os.path.join(tmp, f"shard_{self.shard_id}.npz"), **flat)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({**meta, "step": step,
                       "num_shards": self.num_shards}, f)
        open(os.path.join(tmp, "COMMIT"), "w").close()
        if os.path.exists(d):
            shutil.rmtree(d)
        os.rename(tmp, d)
        self._gc()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def save(self, step: int, state: Any, meta: dict | None = None,
             blocking: bool = True) -> None:
        state = _map_tree(_to_host, state)  # device -> host copy
        if blocking:
            self._write(step, state, meta or {})
        else:
            self.wait()

            def _run():
                try:
                    self._write(step, state, meta or {})
                except BaseException as e:  # surfaced by wait()
                    self._async_exc = e

            self._thread = threading.Thread(target=_run)
            self._thread.start()

    def wait(self) -> None:
        """Join the async writer; re-raise anything it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        exc, self._async_exc = self._async_exc, None
        if exc is not None:
            raise exc

    # ------------------------------------------------------------------ #
    def restore(self, template: Any, step: int | None = None
                ) -> tuple[Any, dict]:
        """Restore into the structure/dtypes of `template`."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        d = self._step_dir(step)
        z = np.load(os.path.join(d, f"shard_{self.shard_id}.npz"),
                    allow_pickle=False)
        flat = {k: z[k] for k in z.files}
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        return _unflatten_like(template, flat), meta

    def restore_flat(self, step: int | None = None
                     ) -> tuple[dict, dict]:
        """Restore the flat {leaf-key: array} dict without a template.

        For callers (e.g. the plan cache) whose state is already a flat
        dict of arrays and who need no dtype/shape coercion."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        d = self._step_dir(step)
        z = np.load(os.path.join(d, f"shard_{self.shard_id}.npz"),
                    allow_pickle=False)
        flat = {k: z[k] for k in z.files}
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        return flat, meta
