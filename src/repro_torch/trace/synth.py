"""Deterministic synthetic TRACE_SCHEMA v0 generator.

Emits an NDJSON dynamic trace of a plausible SSA program: sequential
functions, blocks revisited in a loop pattern (so defs roll over in the
def-table), a hub/recency operand mix that yields the paper's power-law
degree skew (early values act like arguments/globals and become hubs),
`const:*` operands, void stores, and a realistic opcode/type palette.

Used by `chip_smoke.py`'s trace phase to build a 1M-line input without
shipping megabytes of fixture data, and by tests as a property source.
Everything is a pure function of (n_lines, seed, shape params), and the
bytes are those of the JAX package's generator for the same arguments.
"""
from __future__ import annotations

import os
from typing import Iterator

import numpy as np

__all__ = ["iter_synthetic_trace", "synthesize_trace"]

# (op, defines a value?) with sampling weights
_OPS = ("add", "mul", "load", "store", "getelementptr", "icmp", "call",
        "xor", "shl", "phi")
_OP_DEFS = (True, True, True, False, True, True, True, True, True, True)
_OP_P = (0.22, 0.15, 0.20, 0.10, 0.10, 0.06, 0.05, 0.05, 0.04, 0.03)

_TYS = ("i32", "i64", "double", "float", "<4 x float>", "[16 x i8]", "ptr")

_CHUNK = 1 << 14
_HUBS = 8           # first defs per fn act as hubs (args/globals)
_WINDOW = 64        # recency window for non-hub operands


def iter_synthetic_trace(n_lines: int, seed: int = 0, n_fns: int = 4,
                         bbs_per_fn: int = 6, block_len: int = 16,
                         max_uses: int = 3) -> Iterator[str]:
    """Yield `n_lines` NDJSON instruction lines (see module docstring)."""
    rng = np.random.default_rng(seed)
    fn_idx = -1
    k = 0                      # values defined in the current function
    emitted = 0
    while emitted < n_lines:
        m = min(_CHUNK, n_lines - emitted)
        op_i = rng.choice(len(_OPS), size=m, p=_OP_P)
        n_uses = rng.choice(max_uses, size=m,
                            p=_np_uses_p(max_uses)) + 1
        r_kind = rng.random((m, max_uses))      # const / hub / recent
        pick_hub = rng.integers(0, _HUBS, (m, max_uses))
        pick_rec = rng.integers(0, _WINDOW, (m, max_uses))
        const_v = rng.integers(0, 256, (m, max_uses))
        ty_i = rng.integers(0, len(_TYS), (m, max_uses))
        def_ty_i = rng.integers(0, len(_TYS), m)
        redefine = rng.random(m) < 0.03
        with_tys = rng.random(m) < 0.9
        for j in range(m):
            i = emitted + j
            new_fn = i * n_fns // n_lines
            if new_fn != fn_idx:
                fn_idx, k = new_fn, 0
            fn = f"fn{fn_idx}"
            local = i - fn_idx * n_lines // n_fns
            bb = f"bb{(local // block_len) % bbs_per_fn}"
            pp_i = local % block_len
            op = _OPS[op_i[j]]
            uses, use_tys = [], []
            for u in range(n_uses[j]):
                r = r_kind[j, u]
                if r < 0.08:
                    uses.append(f"const:i32:{const_v[j, u]}")
                elif k == 0:
                    uses.append(f"arg{u}")       # live-in before any def
                elif r < 0.30:
                    uses.append(f"v{pick_hub[j, u] % k}")
                else:
                    uses.append(f"v{k - 1 - (pick_rec[j, u] % min(k, _WINDOW))}")
                use_tys.append(_TYS[ty_i[j, u]])
            if _OP_DEFS[op_i[j]]:
                d = (k - 1 - (pick_rec[j, 0] % min(k, _WINDOW))
                     if redefine[j] and k else k)
                def_part = f'"def":"v{d}","def_ty":"{_TYS[def_ty_i[j]]}"'
                if d == k:
                    k += 1
            else:
                def_part = '"def":null'
            tys_part = (',"use_tys":[' + ",".join(
                f'"{t}"' for t in use_tys) + "]") if with_tys[j] else ""
            yield (f'{{"fn":"{fn}","bb":"{bb}","pp":"{fn}:{bb}:i{pp_i}",'
                   f'"op":"{op}",{def_part},'
                   '"uses":[' + ",".join(f'"{u}"' for u in uses) + "]"
                   + tys_part + "}")
        emitted += m


def _np_uses_p(max_uses: int):
    base = [0.35, 0.45, 0.20]
    if max_uses >= 3:
        p = base + [0.0] * (max_uses - 3)
    else:
        p = base[:max_uses]
    s = sum(p)
    return [x / s for x in p]


def synthesize_trace(out, n_lines: int, seed: int = 0, **kw) -> int:
    """Write a synthetic trace to `out` (path or file-like); returns
    the number of lines written."""
    if isinstance(out, (str, os.PathLike)):
        with open(out, "w", encoding="utf-8") as f:
            return synthesize_trace(f, n_lines, seed=seed, **kw)
    lines = 0
    for line in iter_synthetic_trace(n_lines, seed=seed, **kw):
        out.write(line + "\n")
        lines += 1
    return lines
