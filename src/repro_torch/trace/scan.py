"""Vectorized structural-index NDJSON scanner (the fast JSON path).

Instead of `json.loads` per line, the scanner treats the whole byte
stream as data: numpy passes locate every quote, newline, and structural
byte in bulk, token spans become integer arrays, and the rolling
def-table semantics of `ingest._StreamBuilder` are replayed with one
stable lexsort over (function, symbol, time) events — a use binds to
the latest def event before it in its group, a group-leading use of a
non-`const:` symbol materialises (and registers) a live-in, and
`const:` uses with no preceding def materialise fresh vertices.  Edge
weights are evaluated once per unique `(op, use_ty, producer_bytes)`
triple and gathered, so float results are bit-identical to calling the
weight model per edge.

The scanner is *strict and partial*: it accepts only the compact,
machine-written TRACE_SCHEMA v0 subset (no escapes, no whitespace
outside strings, every record carrying fn/bb/pp/op/def/uses, tokens
within fixed width bounds) and proves the input is in that subset with
structural byte accounting before trusting its own parse.  Anything
else — CFG `kind` lines, `on_error="skip"`, iterable/file-like sources,
pretty-printed JSON, unknown keys, a malformed byte — falls back to the
sequential interpreter, which is the semantic reference and owns all
error reporting.  Fallback is whole-file, so diagnostics (line numbers,
messages) are exactly the sequential path's.

The scanner's whole-file batch passes win on small and medium traces
but lose to the streaming interpreter once the file outgrows the
page/CPU caches (the structural index is several full-size temporary
arrays), so by default it only engages for files up to
``REPRO_TRACE_SCAN_MAX_MB`` megabytes on disk (default 24; compressed
inputs are judged by their on-disk size).  Set ``REPRO_TRACE_SCANNER=0``
(or ``off``) to disable the scanner everywhere, or ``=1`` (``on``,
``force``) to engage it regardless of file size.
"""
from __future__ import annotations

import os
from time import perf_counter

import numpy as np

from .. import obs
from ..core.graph import IRGraph
from .schema import type_bytes
from .weights import resolve_weight_model

__all__ = ["SCANNER_ENV", "SCAN_MAX_MB_ENV", "scanner_enabled",
           "scanner_mode", "try_scan_ingest"]

SCANNER_ENV = "REPRO_TRACE_SCANNER"
SCAN_MAX_MB_ENV = "REPRO_TRACE_SCAN_MAX_MB"
DEFAULT_SCAN_MAX_MB = 24.0

_BLOCK = 1 << 24                # structural pass block: 16 MiB
_SYM_W = 24                     # max bytes for ids/ops/types
_PP_W = 48                      # max bytes for pp tokens
_MAX_UNIQUE_PP = 1 << 17

# key classes by (token length, first byte); full bytes verified after
_KEYS = {(2, ord("f")): (0, b"fn"), (2, ord("b")): (1, b"bb"),
         (2, ord("p")): (2, b"pp"), (2, ord("o")): (3, b"op"),
         (3, ord("d")): (4, b"def"), (4, ord("u")): (5, b"uses"),
         (6, ord("d")): (6, b"def_ty"), (7, ord("u")): (7, b"use_tys")}
_NKEYS = 8

_ALLOWED = np.zeros(256, np.bool_)
_ALLOWED[[ord(c) for c in '{}[]:,"nul']] = True
_ALLOWED[10] = True


class _Fallback(Exception):
    """Input outside the scanner's subset — use the sequential path."""


def scanner_mode() -> str:
    """Scanner policy from the environment: "off", "force" or "auto".

    "auto" (the default) engages the scanner only for files whose
    on-disk size is within the `REPRO_TRACE_SCAN_MAX_MB` budget — the
    batch structural passes materialise several full-size temporaries,
    so past the cache-friendly regime the streaming interpreter is
    faster despite parsing line by line.
    """
    v = os.environ.get(SCANNER_ENV, "").lower()
    if v in ("0", "off", "false", "no"):
        return "off"
    if v in ("1", "on", "force", "yes"):
        return "force"
    return "auto"


def scanner_enabled() -> bool:
    return scanner_mode() != "off"


def _scan_size_ok(path: str) -> bool:
    try:
        limit = float(os.environ.get(SCAN_MAX_MB_ENV,
                                     DEFAULT_SCAN_MAX_MB))
    except ValueError:
        limit = DEFAULT_SCAN_MAX_MB
    try:
        return os.path.getsize(path) <= limit * (1 << 20)
    except OSError:
        return True       # let _read_all surface (or fall back on) it


def try_scan_ingest(source, *, weight_model="bytes", on_error="raise",
                    cfg=None, name=None, keep_labels=False):
    """Scan `source` if eligible; return `(IRGraph, TraceStats)` or None.

    None means "not handled" — the caller runs the sequential ingester,
    which reproduces both the result and any error diagnostics.
    """
    mode = scanner_mode()
    if mode == "off":
        return None
    if cfg is not None or on_error != "raise":
        obs.event("trace.scan_fallback", reason="cfg_or_on_error")
        return None
    if not isinstance(weight_model, str):
        # user callables may be stateful; the scanner evaluates weights
        # per unique triple, which is only sound for pure models
        obs.event("trace.scan_fallback", reason="weight_model_callable")
        return None
    if not isinstance(source, (str, os.PathLike)):
        obs.event("trace.scan_fallback", reason="not_a_path")
        return None
    path = os.fspath(source)
    if mode == "auto" and not _scan_size_ok(path):
        obs.event("trace.scan_fallback", reason="size_budget")
        return None
    try:
        data = _read_all(path)
    except (_Fallback, OSError):
        obs.event("trace.scan_fallback", reason="read_error")
        return None
    from .ingest import _source_name
    t0 = perf_counter()
    try:
        out = _scan_bytes(data, resolve_weight_model(weight_model),
                          keep_labels, _source_name(source, name))
    except _Fallback:
        obs.event("trace.scan_fallback", reason="structure")
        return None
    if obs.enabled():
        t1 = perf_counter()
        m = int(out[0].num_edges)
        obs.complete("trace.ingest", t0, t1, engine="scan",
                     bytes=len(data), edges=m,
                     edges_per_s=round(m / max(t1 - t0, 1e-9)))
    return out


def _read_all(path: str) -> bytes:
    if path.endswith(".gz"):
        import gzip
        with gzip.open(path, "rb") as f:
            return f.read()
    if path.endswith((".zst", ".zstd")):
        try:
            import zstandard
        except ImportError:
            raise _Fallback from None      # sequential raises the real error
        with open(path, "rb") as fh:
            return zstandard.ZstdDecompressor().stream_reader(fh).read()
    with open(path, "rb") as f:
        return f.read()


# ---------------------------------------------------------------------- #
# structural pass (blocked so every temporary stays small)
# ---------------------------------------------------------------------- #
def _structural_scan(mv: np.ndarray):
    """One blocked pass: quote/newline positions, string-interior
    residue validation, and residue byte counts for the structural
    accounting checks.  Raises `_Fallback` on any byte outside the
    compact subset (escapes, whitespace, digits outside strings, ...).
    """
    quotes, newlines = [], []
    counts = np.zeros(256, np.int64)
    parity = 0
    for lo in range(0, mv.shape[0], _BLOCK):
        blk = mv[lo:lo + _BLOCK]
        if np.count_nonzero(blk == 92):
            raise _Fallback                 # escapes break quote pairing
        qmask = blk == 34
        q = np.flatnonzero(qmask)
        if q.size:
            quotes.append(q.astype(np.int32) + np.int32(lo))
        nlmask = blk == 10
        nl = np.flatnonzero(nlmask)
        if nl.size:
            newlines.append(nl.astype(np.int32) + np.int32(lo))
        # control bytes are invalid JSON inside strings and must all be
        # the newlines that terminate lines
        if np.count_nonzero(blk < 32) != nl.size:
            raise _Fallback
        # parity of preceding quotes -> inside-string mask (uint8 cumsum
        # wraps mod 256, which preserves the parity bit)
        qm8 = qmask.view(np.uint8)
        cq = np.cumsum(qm8, dtype=np.uint8)
        inside = ((cq - qm8 + np.uint8(parity)) & np.uint8(1)).view(np.bool_)
        parity = (parity + int(cq[-1])) & 1 if blk.size else parity
        if inside[nlmask].any():
            raise _Fallback                 # newline inside a string
        counts += np.bincount(blk[~inside], minlength=256)
    if parity:
        raise _Fallback                     # unterminated string
    # disallowed residue bytes (escapes, whitespace, digits, ...) show up
    # as nonzero counts outside the allowed set — one check, no gathers
    if int(counts[~_ALLOWED].sum()) or int(counts[92]):
        raise _Fallback
    cat = (np.concatenate(quotes) if quotes else np.zeros(0, np.int32),
           np.concatenate(newlines) if newlines else np.zeros(0, np.int32))
    return cat[0], cat[1], counts


def _pack_tokens(mv, starts, lens, width):
    """Zero-padded (k, width) uint8 matrix of token bytes (longer tokens
    truncate — callers bound the lengths of the tokens they care about),
    gathered in bounded slices so no temporary exceeds ~40 MB."""
    k = starts.shape[0]
    out = np.zeros((k, width), np.uint8)
    if not k:
        return out
    step = max(1, (1 << 22) // width)
    col = np.arange(width, dtype=np.int64)
    for lo in range(0, k, step):
        s = slice(lo, min(lo + step, k))
        offs = starts[s, None] + col[None, :]
        valid = col[None, :] < np.minimum(lens[s, None], width)
        out[s] = np.take(mv, np.minimum(offs, mv.shape[0] - 1)) * valid
    return out


def _pack_cols(mv, tok_ids, starts, lens, width, presence=False):
    """u64 column arrays over the given tokens' packed bytes; `tok_ids`
    may contain -1 (absent field) -> all-zero rows, distinguished from
    real empty-string tokens by the optional presence column."""
    ids = np.maximum(tok_ids, 0)
    present = tok_ids >= 0
    s = starts[ids].astype(np.int64)
    ln = np.where(present, lens[ids], 0).astype(np.int64)
    # shrink to the smallest 8-byte multiple that holds every token —
    # identity is preserved within one call, and most id/op/type tokens
    # are far below the 24-byte bound
    wmax = int(ln.max()) if ln.size else 0
    width = min(width, max(8, -(-wmax // 8) * 8))
    mat = _pack_tokens(mv, s, ln, width)
    cols = [np.ascontiguousarray(mat[:, 8 * i:8 * i + 8]).view("<u8").ravel()
            for i in range(width // 8)]
    if presence:
        return [present.astype(np.int8)] + cols
    return cols


def _unique_rows(cols):
    """(sort_order_repr, inverse, n_unique) for rows given as equal-length
    integer column arrays — a lexsort-based np.unique(axis=0)."""
    k = cols[0].shape[0]
    if k == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64), 0
    order = np.lexsort(tuple(reversed(cols)))
    new = np.zeros(k, np.bool_)
    new[0] = True
    for c in cols:
        cs = c[order]
        new[1:] |= cs[1:] != cs[:-1]
    uid_sorted = np.cumsum(new) - 1
    inverse = np.empty(k, np.int64)
    inverse[order] = uid_sorted
    repr_idx = order[new]
    return repr_idx, inverse, int(uid_sorted[-1]) + 1


def _decode(mv, start, length) -> str:
    return bytes(mv[start:start + length]).decode("utf-8")


# ---------------------------------------------------------------------- #
# the scan
# ---------------------------------------------------------------------- #
def _scan_bytes(data: bytes, weight_fn, keep_labels: bool, name: str):
    from .ingest import TraceStats
    mv = np.frombuffer(data, np.uint8)
    nbytes = mv.shape[0]
    if nbytes == 0:
        g = IRGraph(n=0, src=np.zeros(0, np.int32), dst=np.zeros(0, np.int32),
                    w=np.zeros(0, np.float64), name=name,
                    node_labels=[] if keep_labels else None)
        return g, TraceStats(engine="scan")

    quotes, newlines, res_counts = _structural_scan(mv)
    if quotes.shape[0] % 2:
        raise _Fallback
    has_final_nl = nbytes and mv[-1] == 10
    if not has_final_nl:
        newlines = np.append(newlines, np.int32(nbytes))
    L = newlines.shape[0]                   # total lines (blank included)

    starts = quotes[0::2] + 1
    ends = quotes[1::2]                     # position of closing quote
    lens = ends - starts
    T = starts.shape[0]
    if T == 0:
        raise _Fallback                     # only blank lines? let seq decide
    if int(ends[-1]) + 1 >= nbytes or int(starts[0]) < 2:
        raise _Fallback
    after = mv[ends + 1]
    before = mv[starts - 2]                 # byte before the opening quote
    is_key = after == 58                    # ':'

    # ---- key classification (verified byte-exact) -------------------- #
    kcls = np.full(T, -1, np.int8)
    kstarts, klens = starts[is_key], lens[is_key]
    kfirst = mv[np.minimum(kstarts, nbytes - 1)]
    kc = np.full(kstarts.shape[0], -1, np.int8)
    for (length, first), (cls, full) in _KEYS.items():
        m = (klens == length) & (kfirst == first)
        if not m.any():
            continue
        sel = kstarts[m]
        ok = np.ones(sel.shape[0], np.bool_)
        for j, ch in enumerate(full):
            ok &= mv[sel + j] == ch
        if not ok.all():
            raise _Fallback                 # unknown key (incl. "kind")
        kc[m] = cls
    if (kc < 0).any():
        raise _Fallback
    kcls[is_key] = kc

    # ---- adjacency checks -------------------------------------------- #
    kb, vb, va = before[is_key], before[~is_key], after[~is_key]
    if not (((kb == 123) | (kb == 44)).all()
            and ((vb == 58) | (vb == 91) | (vb == 44)).all()
            and ((va == 44) | (va == 125) | (va == 93)).all()):
        raise _Fallback

    # ---- token -> line / record mapping ------------------------------ #
    # L binary searches into T tokens beats T searches into L newlines
    cum = np.searchsorted(starts, newlines, side="left")
    tok_per_line = np.diff(np.concatenate((np.zeros(1, np.int64), cum)))
    line_of = np.repeat(np.arange(L, dtype=np.int32), tok_per_line)
    nonempty = tok_per_line > 0
    # token-less lines must be zero-length (true blank lines)
    line_begin = np.concatenate((np.zeros(1, np.int32), newlines[:-1] + 1))
    line_len = newlines - line_begin
    if (line_len[~nonempty] != 0).any():
        raise _Fallback
    R = int(np.count_nonzero(nonempty))
    rec_of_line = np.cumsum(nonempty) - 1   # valid on nonempty lines
    # every nonempty line is "{...}"
    if not ((mv[line_begin[nonempty]] == 123).all()
            and (mv[np.minimum(newlines[nonempty], nbytes) - 1] == 125).all()):
        raise _Fallback

    # ---- owner key for every value token ----------------------------- #
    tidx = np.arange(T, dtype=np.int32)
    key_pos = np.where(is_key, tidx, np.int32(-1))
    owner = np.maximum.accumulate(key_pos)
    vmask = ~is_key
    vowner = owner[vmask]
    if (vowner < 0).any() or (line_of[vmask] != line_of[vowner]).any():
        raise _Fallback
    vcls = kcls[vowner]
    vline = line_of[vmask]
    vlens = lens[vmask]

    # ---- per-record key/value count grammar -------------------------- #
    rec_of_key = rec_of_line[line_of[is_key]]
    rec_of_val = rec_of_line[vline]
    kcount = np.bincount(rec_of_key * _NKEYS + kcls[is_key],
                         minlength=R * _NKEYS).reshape(R, _NKEYS)
    vcount = np.bincount(rec_of_val * _NKEYS + vcls,
                         minlength=R * _NKEYS).reshape(R, _NKEYS)
    if (kcount[:, :6] != 1).any() or (kcount[:, 6:] > 1).any():
        raise _Fallback
    if (vcount[:, :4] != 1).any() or (vcount[:, 4] > 1).any():
        raise _Fallback
    if (vcount[:, 6] != kcount[:, 6]).any():
        raise _Fallback
    has_use_tys = kcount[:, 7] == 1
    n_uses = vcount[:, 5]
    if (vcount[:, 7] != np.where(has_use_tys, n_uses, 0)).any():
        raise _Fallback

    # ---- "null" accounting (def: null is the only legal null) -------- #
    null_def = vcount[:, 4] == 0
    n_null = int(np.count_nonzero(null_def))
    if (int(res_counts[ord("n")]) != n_null
            or int(res_counts[ord("u")]) != n_null
            or int(res_counts[ord("l")]) != 2 * n_null):
        raise _Fallback
    def_key_end = np.full(R, -1, np.int64)
    dk = kcls[is_key] == 4
    def_key_end[rec_of_key[dk]] = ends[is_key][dk]
    if n_null:
        e = def_key_end[null_def]
        if (e + 6 > nbytes).any():
            raise _Fallback
        for j, ch in enumerate(b"null"):
            if not (mv[e + 2 + j] == ch).all():
                raise _Fallback

    # ---- global structural counts ------------------------------------ #
    total_keys = int(np.count_nonzero(is_key))
    n_arrays = int(kcount[:, 5].sum() + kcount[:, 7].sum())
    exp_commas = (total_keys - R
                  + int(np.maximum(n_uses - 1, 0).sum())
                  + int(np.maximum(vcount[:, 7] - 1, 0).sum()))
    if (int(res_counts[123]) != R or int(res_counts[125]) != R
            or int(res_counts[91]) != n_arrays
            or int(res_counts[93]) != n_arrays
            or int(res_counts[58]) != total_keys
            or int(res_counts[44]) != exp_commas):
        raise _Fallback

    # ---- field extraction -------------------------------------------- #
    vtok = np.flatnonzero(vmask).astype(np.int32)   # token id per value
    # every packed-width-bound token (ids, ops, types — everything but
    # pp) must fit in _SYM_W bytes, else identity packing is lossy
    if int(np.max(vlens[vcls != 2], initial=0)) > _SYM_W:
        raise _Fallback

    def field_tok(cls):
        m = vcls == cls
        out = np.full(R, -1, np.int64)
        out[rec_of_val[m]] = vtok[m]
        return out

    fn_tok = field_tok(0)
    bb_tok = field_tok(1)
    pp_tok = field_tok(2)
    op_tok = field_tok(3)
    def_tok = field_tok(4)                  # -1 where def: null
    defty_tok = field_tok(6)                # -1 where absent
    use_m = vcls == 5
    use_tok = vtok[use_m]                   # token ids, in use order
    rec_of_use = rec_of_val[use_m]
    E = use_tok.shape[0]
    use_start = np.concatenate(([0], np.cumsum(n_uses)))[:-1]
    uty_m = vcls == 7
    uty_tok_ids = vtok[uty_m]
    uty_rec = rec_of_val[uty_m]
    use_ty_tok = np.full(E, -1, np.int64)
    if uty_tok_ids.size:
        grp_new = np.ones(uty_rec.shape[0], np.bool_)
        grp_new[1:] = uty_rec[1:] != uty_rec[:-1]
        ordinal = np.arange(uty_rec.shape[0]) - np.maximum.accumulate(
            np.where(grp_new, np.arange(uty_rec.shape[0]), 0))
        use_ty_tok[use_start[uty_rec] + ordinal] = uty_tok_ids

    # ---- interning --------------------------------------------------- #
    def pack(tok_ids, presence=False):
        return _pack_cols(mv, tok_ids, starts, lens, _SYM_W,
                          presence=presence)

    fn_repr, fn_uid, nF = _unique_rows(pack(fn_tok))
    bb_repr, fb_uid, nB = _unique_rows([fn_uid] + pack(bb_tok))
    op_repr, op_uid, nO = _unique_rows(pack(op_tok))
    has_defty = defty_tok >= 0
    ty_tok_all = np.concatenate((defty_tok, use_ty_tok))
    ty_repr, ty_uid_all, nTy = _unique_rows(pack(ty_tok_all, presence=True))
    defty_uid, use_ty_uid = ty_uid_all[:R], ty_uid_all[R:]

    fn_strs = [_decode(mv, starts[fn_tok[i]], lens[fn_tok[i]])
               for i in fn_repr]
    op_strs = [_decode(mv, starts[op_tok[i]], lens[op_tok[i]])
               for i in op_repr]
    ty_strs = []
    for i in ty_repr:
        t = ty_tok_all[i]
        ty_strs.append(None if t < 0 else _decode(mv, starts[t], lens[t]))
    ty_bytes = np.array([-1.0 if s is None else type_bytes(s)
                         for s in ty_strs])

    # ---- pp validation + ordering ------------------------------------ #
    # pp_repr entries are record indices (one pp token per record), so
    # validating each *unique* pp against its representative record's
    # own fn/bb, then checking all records share that (fn, bb) via the
    # interned uids, proves pp == f"{fn}:{bb}:i{idx}" for every record.
    if int(lens[pp_tok].max(initial=0)) > _PP_W:
        raise _Fallback
    pp_packed = _pack_tokens(mv, starts[pp_tok], lens[pp_tok], _PP_W)
    ppk = [pp_packed[:, 8 * i:8 * i + 8].copy().view("<u8").ravel()
           for i in range(_PP_W // 8)]
    pp_repr, pp_uid, nP = _unique_rows(ppk)
    if nP > _MAX_UNIQUE_PP:
        raise _Fallback
    exp_fn = np.empty(nP, np.int64)
    exp_fb = np.empty(nP, np.int64)
    idx_of_pp = np.empty(nP, np.int64)
    for u, r in enumerate(pp_repr.tolist()):
        s = _decode(mv, starts[pp_tok[r]], lens[pp_tok[r]])
        head, sep, tail = s.rpartition(":i")
        if not sep or not tail.isdigit():
            raise _Fallback
        fnp, sep2, bbp = head.partition(":")
        if not sep2 or fnp != fn_strs[int(fn_uid[r])] \
                or bbp != _decode(mv, starts[bb_tok[r]], lens[bb_tok[r]]):
            raise _Fallback                 # seq path would reject this pp
        exp_fn[u] = fn_uid[r]
        exp_fb[u] = fb_uid[r]
        idx_of_pp[u] = int(tail)
    if (exp_fn[pp_uid] != fn_uid).any() or (exp_fb[pp_uid] != fb_uid).any():
        raise _Fallback
    idx = idx_of_pp[pp_uid]

    same = np.zeros(R, np.bool_)
    if R > 1:
        same[1:] = (fn_uid[1:] == fn_uid[:-1]) & (fb_uid[1:] == fb_uid[:-1])
    viol = np.flatnonzero(same & np.concatenate(
        ([False], idx[1:] <= idx[:-1])) if R > 1 else np.zeros(0, np.bool_))
    if viol.size:
        run_id = np.cumsum(~same) - 1
        run_start = np.flatnonzero(~same)
        latest_first = {}
        for j in viol.tolist():
            rid = int(run_id[j])
            first = latest_first.get(rid, int(idx[run_start[rid]]))
            if int(idx[j]) <= first:
                latest_first[rid] = int(idx[j])     # block re-entry
            else:
                raise _Fallback                     # out-of-order pp

    # ---- event binding ----------------------------------------------- #
    has_def = def_tok >= 0
    def_recs = np.flatnonzero(has_def)
    D = def_recs.shape[0]
    sym_tok = np.concatenate((use_tok, def_tok[def_recs]))
    sym_fn = np.concatenate((fn_uid[rec_of_use], fn_uid[def_recs]))
    sym_cols = pack(sym_tok)
    _, ssym, nS = _unique_rows([sym_fn] + sym_cols)
    # const flag per scoped symbol (first 6 bytes == b"const:")
    CONST6 = int.from_bytes(b"const:", "little")
    is_const_ev_src = (sym_cols[0] & 0xFFFFFFFFFFFF) == CONST6
    sym_is_const = np.zeros(nS, np.bool_)
    sym_is_const[ssym] = is_const_ev_src    # consistent across the group

    ev_time = np.concatenate((2 * rec_of_use, 2 * def_recs + 1))
    ev_isdef = np.concatenate((np.zeros(E, np.bool_), np.ones(D, np.bool_)))
    ev_use = np.concatenate((np.arange(E), np.full(D, -1)))
    ev_rec = np.concatenate((rec_of_use, def_recs))
    order = np.lexsort((ev_time, ssym))
    s_sym = ssym[order]
    s_isdef = ev_isdef[order]
    s_use = ev_use[order]
    s_rec = ev_rec[order]
    N = order.shape[0]
    gs = np.ones(N, np.bool_)
    if N > 1:
        gs[1:] = s_sym[1:] != s_sym[:-1]
    s_const = sym_is_const[s_sym]
    eff = s_isdef | (gs & ~s_isdef & ~s_const)
    j = np.arange(N)
    P = np.maximum.accumulate(np.where(eff, j, -1))
    S = np.maximum.accumulate(np.where(gs, j, -1))
    is_use_ev = ~s_isdef
    bound = is_use_ev & ~eff & (P >= S)
    creator = is_use_ev & eff
    const_fresh = is_use_ev & ~eff & ~bound
    if (const_fresh & ~s_const).any():
        raise _Fallback                     # unreachable by construction

    fresh_sorted = creator | const_fresh
    fresh = np.zeros(E, np.bool_)
    fresh[s_use[fresh_sorted]] = True

    # ---- vertex numbering (record, then fresh uses, interleaved) ----- #
    cfx = np.concatenate(([0], np.cumsum(fresh)))   # exclusive prefix
    rec_vertex = np.arange(R) + cfx[use_start]
    fresh_slot = (rec_vertex[rec_of_use] + 1
                  + (cfx[np.arange(E)] - cfx[use_start[rec_of_use]]))
    n_total = R + int(cfx[-1])

    # ---- producers, pbytes, src/dst ---------------------------------- #
    def_bytes = np.full(R, -1.0)
    def_bytes[has_defty] = ty_bytes[defty_uid[has_defty]]
    prod = P[np.flatnonzero(bound)]
    bpos = np.flatnonzero(bound)
    prod_vert = np.where(s_isdef[prod], rec_vertex[s_rec[prod]],
                         fresh_slot[np.maximum(s_use[prod], 0)])
    prod_bytes = np.where(s_isdef[prod] & (def_bytes[s_rec[prod]] >= 0),
                          def_bytes[s_rec[prod]], -1.0)
    src = np.empty(E, np.int64)
    src[s_use[bpos]] = prod_vert
    src[fresh] = fresh_slot[fresh]
    pb = np.full(E, -1.0)
    pb[s_use[bpos]] = prod_bytes
    dst = rec_vertex[rec_of_use]

    # ---- weights: one call per unique (op, use_ty, pbytes) ----------- #
    op_of_use = op_uid[rec_of_use]
    w_repr, w_inv, nW = _unique_rows([op_of_use, use_ty_uid,
                                      np.ascontiguousarray(pb).view(np.int64)])
    w_uniq = np.empty(nW)
    for u, i in enumerate(w_repr):
        p = pb[i]
        w_uniq[u] = weight_fn(op_strs[int(op_of_use[i])],
                              ty_strs[int(use_ty_uid[i])],
                              None if p < 0 else float(p))
    w = w_uniq[w_inv]

    # ---- labels ------------------------------------------------------ #
    labels = None
    if keep_labels:
        lab = np.empty(n_total, object)
        lab[rec_vertex] = np.array(op_strs, object)[op_uid]
        cf_use = np.zeros(E, np.bool_)
        cf_use[s_use[const_fresh]] = True
        li_use = np.zeros(E, np.bool_)
        li_use[s_use[creator]] = True
        lab[fresh_slot[cf_use]] = "const"
        li_idx = np.flatnonzero(li_use)
        for e in li_idx.tolist():
            t = use_tok[e]
            lab[fresh_slot[e]] = _decode(mv, starts[t], lens[t])
        labels = list(lab)

    stats = TraceStats(
        lines=int(L), records=R,
        const_uses=int(np.count_nonzero(const_fresh)),
        livein_uses=int(np.count_nonzero(creator)),
        void_defs=n_null, functions=nF, blocks=nB, engine="scan")
    g = IRGraph(n=n_total, src=src.astype(np.int32),
                dst=dst.astype(np.int32), w=w, name=name,
                node_labels=labels)
    return g, stats
