"""The fused AdamW on the card: the leaf tables and launches of
`csrc/adamw.cu`.

`update` takes the leaves of the parameters, gradients and moments (in
`tree_leaves` order) and the step counter, all CUDA tensors of one card,
and runs `adamw_update`'s whole update in three kernel launches a group
of leaves (`plan`; one group holds up to the library's
`adamw_max_leaves()`): the clip's sum of squares, one block that finishes
the norm, the scale, the step and its schedule, and the update of every
leaf.  Nothing is read back to the host.  Parameters, gradients and
moments may be float32 or bfloat16, each leaf and operand its own; a
gradient that is not contiguous is copied first, and a parameter or
moment that is not contiguous is updated through a contiguous copy that
is written back.

`launches` counts the calls of `update`, each one fused update of three
or more kernel launches, as `flash_attention.launches_bwd` counts a
backward of three; a run sets it to 0 and reads it back to show that a
path went through the kernels, with or without an `obs` collector.
"""
from __future__ import annotations

import ctypes
import itertools

import numpy as np
import torch

from ..core.cuda import _build

__all__ = ["update", "plan", "leaf_tables", "CHUNK"]

launches = 0

CHUNK = 1 << 14          # elements a block, of the norm and the update
# a leaf's dtype code: bit k set where operand k of (p, g, m, v) is
# bfloat16, the others float32
_CODES = {dtypes: sum((d == torch.bfloat16) << k for k, d in
                      enumerate(dtypes))
          for dtypes in itertools.product((torch.float32, torch.bfloat16),
                                          repeat=4)}
_lib = None


def _library():
    """The kernel library with the AdamW entries' C signatures declared."""
    global _lib
    if _lib is None:
        lib = _build.load_library()
        vp, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int32,
                             ctypes.c_int64, ctypes.c_float)
        lib.adamw_max_leaves.restype = i32
        lib.adamw_max_leaves.argtypes = []
        # rows, n, chunk, blocks, partials, stream
        lib.adamw_norm.restype = ctypes.c_int
        lib.adamw_norm.argtypes = [vp, i32, i64, i64, vp, vp]
        # partials, n_partials, step_in, step_out, scal, clip, lr, b1, b2,
        # warmup, total, stream
        lib.adamw_finish.restype = ctypes.c_int
        lib.adamw_finish.argtypes = [vp, i64, vp, vp, vp, f32, f32, f32, f32,
                                     i64, i64, vp]
        # rows, n, chunk, blocks, scal, b1, 1 - b1, b2, 1 - b2, eps, wd,
        # stream
        lib.adamw_apply.restype = ctypes.c_int
        lib.adamw_apply.argtypes = [vp, i32, i64, i64, vp] + [f32] * 6 + [vp]
        _lib = lib
    return _lib


def plan(numels: list[int], max_leaves: int, chunk: int = CHUNK) -> list:
    """The leaves cut into launches: a list of (first leaf, end leaf,
    starts) in order, at most `max_leaves` leaves each, where starts[k] is
    the first block of leaf first + k, one block for every `chunk`
    elements of a leaf (none for an empty leaf), and starts[-1] is the
    launch's number of blocks."""
    groups = []
    for first in range(0, len(numels), max_leaves):
        end = min(first + max_leaves, len(numels))
        starts = [0]
        for n in numels[first:end]:
            starts.append(starts[-1] + -(-n // chunk))
        groups.append((first, end, starts))
    return groups


def leaf_tables(ps, gs, ms, vs, p_out, m_out, v_out, max_leaves: int,
                chunk: int = CHUNK) -> list:
    """The launches' leaf tables: (rows, leaves, blocks) for each group of
    `plan`, rows an int64 [leaves, 10] array of (p, g, m, v, p_out,
    m_out, v_out addresses, elements, dtype code, first block), the rows
    `csrc/adamw.cu` reads (`fill`).  The outputs are the inputs where the
    lists are the same objects.  One pass over the leaves: this runs on
    the host every step.  Raises on a leaf the kernels do not take:
    another dtype than float32 or bfloat16, or a gradient or moment of
    another size.  The leaves' card is the caller's to check (one card,
    `adamw._on_card`)."""
    inplace = p_out is ps and m_out is ms and v_out is vs
    rows = []
    for p, g, m, v, po, mo, vo in zip(ps, gs, ms, vs, p_out, m_out, v_out):
        n = p.numel()
        code = _CODES.get((p.dtype, g.dtype, m.dtype, v.dtype))
        if code is None:
            raise TypeError(f"the fused AdamW takes float32 or bfloat16 "
                            f"leaves, not {p.dtype}, {g.dtype}, {m.dtype}, "
                            f"{v.dtype}")
        if not g.numel() == m.numel() == v.numel() == n:
            raise ValueError(f"a parameter of {n} elements beside a "
                             f"gradient and moments of {g.numel()}, "
                             f"{m.numel()}, {v.numel()}")
        pp, mp, vp = p.data_ptr(), m.data_ptr(), v.data_ptr()
        if inplace:
            rows.append((pp, g.data_ptr(), mp, vp, pp, mp, vp, n, code, 0))
        else:
            rows.append((pp, g.data_ptr(), mp, vp, po.data_ptr(),
                         mo.data_ptr(), vo.data_ptr(), n, code, 0))
    table = np.array(rows, dtype=np.int64).reshape(-1, 10)
    tables = []
    for first, end, starts in plan(table[:, 7].tolist(), max_leaves, chunk):
        part = table[first:end]         # a view: its rows are contiguous
        part[:, 9] = starts[:-1]
        tables.append((part, end - first, starts[-1]))
    return tables


def update(ps: list, gs: list, ms: list, vs: list, step: torch.Tensor,
           cfg, inplace: bool):
    """One AdamW step of `cfg` (an `AdamWConfig`) on one card, every leaf
    and the step on it: (new parameters, new m, new v, new step, scalars), the scalars a float32
    [5] tensor (grad norm, clip scale, lr, 1 - b1^t, 1 - b2^t).  With
    `inplace` the new values are written into the given tensors, which
    are returned; otherwise into new ones, the inputs left as they are."""
    global launches
    device = ps[0].device
    if step.dtype != torch.int32 or step.dim() != 0 or step.device != device:
        raise ValueError("the step must be an int32 scalar on the "
                         "parameters' card")
    lib = _library()
    gs = [g.contiguous() for g in gs]
    ins = [[t.contiguous() for t in leaves] for leaves in (ps, ms, vs)]
    if inplace:         # into the leaves, or their contiguous copies
        outs = ins
        new_step = step
    else:
        outs = [[torch.empty_like(c) for c in dense] for dense in ins]
        new_step = torch.empty((), dtype=torch.int32, device=device)
    (p_in, m_in, v_in) = ins
    tables = leaf_tables(p_in, gs, m_in, v_in, *outs, lib.adamw_max_leaves())
    n_partials = sum(blocks for _, _, blocks in tables)
    partials = torch.empty(max(n_partials, 1), dtype=torch.float64,
                           device=device)
    scal = torch.empty(5, dtype=torch.float32, device=device)
    with torch.cuda.device(device):       # launch on the leaves' card
        stream = torch.cuda.current_stream().cuda_stream
        at = partials.data_ptr()
        for rows, n, blocks in tables:
            _ok(lib.adamw_norm(rows.ctypes.data, n, CHUNK, blocks, at,
                               stream), "norm")
            at += 8 * blocks
        _ok(lib.adamw_finish(partials.data_ptr(), n_partials,
                             step.data_ptr(), new_step.data_ptr(),
                             scal.data_ptr(), cfg.clip_norm, cfg.lr, cfg.b1,
                             cfg.b2, cfg.warmup_steps, cfg.total_steps,
                             stream), "finish")
        for rows, n, blocks in tables:
            _ok(lib.adamw_apply(rows.ctypes.data, n, CHUNK, blocks,
                                scal.data_ptr(), cfg.b1, 1 - cfg.b1, cfg.b2,
                                1 - cfg.b2, cfg.eps, cfg.weight_decay,
                                stream), "update")
    if inplace:
        for leaves, dense in zip((ps, ms, vs), ins):
            for t, c in zip(leaves, dense):
                if c is not t:
                    t.copy_(c)
        outs = [ps, ms, vs]
    launches += 1
    return (*outs, new_step, scal)


def _ok(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"AdamW {what} kernel launch failed: CUDA error "
                           f"{rc}")

