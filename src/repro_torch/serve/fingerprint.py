"""Content-addressed plan fingerprints.

A plan is a pure function of (graph content, planning knobs) — every
engine in the pipeline is deterministic and backend choice never changes
the result (the backend equivalence contract).  The fingerprint therefore hashes
exactly those two things:

  * **content digest** — blake2b over the canonical edge arrays of an
    `IRGraph` (n, src, dst, w as little-endian bytes), or over the raw
    bytes of a trace file, streamed in 1 MiB chunks.  Hashing the file
    bytes rather than the parsed graph means a cache hit never pays the
    parse — which is what makes hits ~free on multi-hundred-MB traces.
  * **knob digest** — canonical JSON over the result-relevant planning
    knobs (p, method, λ, seed, edge_order, weight_model, and any extras
    that change the output, e.g. dist-pipeline round quanta).

`FP_VERSION` is folded in so persisted caches invalidate themselves when
the fingerprint scheme (or bundle layout) changes.

A per-process **stat memo** maps (realpath, size, mtime_ns) -> content
digest so repeated requests against an unchanged file skip even the
hashing pass.  It is advisory only: a rewritten file with identical
size+mtime_ns (sub-resolution filesystems) could alias, so callers can
opt out with `use_stat_memo=False`.
"""
from __future__ import annotations

import hashlib
import json
import os

import numpy as np

__all__ = ["FP_VERSION", "content_digest", "graph_digest", "knob_digest",
           "plan_fingerprint", "clear_stat_memo"]

FP_VERSION = 1
_CHUNK = 1 << 20

_stat_memo: dict = {}


def clear_stat_memo() -> None:
    _stat_memo.clear()


def content_digest(source, use_stat_memo: bool = True) -> str:
    """Digest of the graph content behind `source` (path or IRGraph)."""
    if isinstance(source, (str, os.PathLike)):
        return _path_digest(os.fspath(source), use_stat_memo)
    return graph_digest(source)


def _path_digest(path: str, use_stat_memo: bool) -> str:
    real = os.path.realpath(path)
    key = None
    if use_stat_memo:
        st = os.stat(real)
        key = (real, st.st_size, st.st_mtime_ns)
        hit = _stat_memo.get(key)
        if hit is not None:
            return hit
    h = hashlib.blake2b(digest_size=20)
    with open(real, "rb") as f:
        while True:
            chunk = f.read(_CHUNK)
            if not chunk:
                break
            h.update(chunk)
    digest = h.hexdigest()
    if key is not None:
        _stat_memo[key] = digest
    return digest


def graph_digest(g) -> str:
    """Digest of an in-memory `IRGraph`'s canonical edge arrays."""
    h = hashlib.blake2b(digest_size=20)
    h.update(f"n={int(g.n)};m={int(g.num_edges)};".encode())
    # '<' pins byte order so the digest is host-independent
    h.update(np.ascontiguousarray(g.src, dtype="<i4").tobytes())
    h.update(np.ascontiguousarray(g.dst, dtype="<i4").tobytes())
    h.update(np.ascontiguousarray(g.w, dtype="<f8").tobytes())
    return h.hexdigest()


def knob_digest(p: int, method: str, lam: float, seed: int,
                edge_order: str, weight_model: str,
                extras: dict | None = None) -> str:
    doc = {"v": FP_VERSION, "p": int(p), "method": str(method),
           "lam": float(lam), "seed": int(seed),
           "edge_order": str(edge_order),
           "weight_model": str(weight_model),
           "extras": dict(sorted((extras or {}).items()))}
    blob = json.dumps(doc, sort_keys=True, separators=(",", ":"))
    return hashlib.blake2b(blob.encode(), digest_size=12).hexdigest()


def plan_fingerprint(source, p: int, method: str, lam: float,
                     seed: int = 0, edge_order: str = "auto",
                     weight_model: str = "bytes",
                     extras: dict | None = None,
                     use_stat_memo: bool = True) -> str:
    """`<content>-<knobs>` — the plan cache key."""
    return (content_digest(source, use_stat_memo=use_stat_memo)
            + "-" + knob_digest(p, method, lam, seed, edge_order,
                                weight_model, extras))
