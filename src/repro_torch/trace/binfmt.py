"""Binary columnar trace container v1 (`.rtb`) — convert once, ingest fast.

NDJSON is the interchange format; this is the *ingest-once* format the
ROADMAP's "break the ingestion wall" item calls for: after one
`python -m repro_torch.trace convert trace.ndjson trace.rtb`, every later run
(partition sweeps, dist sharding, benchmarks) loads the exact IRGraph
the NDJSON path would have built, at memory bandwidth instead of JSON
parse speed.

Container layout (all integers little-endian; the JAX package's
`docs/trace-format.md` is the normative spec, and a container either
package writes, the other reads):

    offset  size  field
    0       8     magic  b"REPROTB\\x00"
    8       2     format version (u16, currently 1)
    10      4     header length H (u32)
    14      H     header JSON (utf-8)
    14+H    ...   chunk payloads, then optional per-vertex label ids

The header records graph shape (`n`, `edges`, `name`), the column dtypes
(`src`/`dst` = "<i4", `w` = "<f8"), a chunk table (edge counts in file
order), the ingestion `stats` captured at conversion time, and an
optional label string table.  Each chunk payload is the raw bytes of its
`src`, `dst`, and `w` column slices, concatenated in that order —
`np.frombuffer`-able with zero parsing.

`.rtb.gz` and `.rtb.zst`/`.rtb.zstd` paths wrap the same byte stream in
gzip / zstandard (the latter via the optional `zstandard` package),
mirroring the NDJSON reader's transparent decompression.

Malformed containers raise `BinaryFormatError` with the same
debuggability contract as the NDJSON path's `TraceFormatError`: the
message names the file and the first structural problem found (bad
magic, unsupported version, dtype mismatch, truncated chunk, ...).
"""
from __future__ import annotations

import io
import json
import os
import struct

import numpy as np

from ..core.graph import IRGraph

__all__ = ["BINARY_MAGIC", "BINARY_VERSION", "BinaryFormatError",
           "is_binary_trace_path", "write_trace_bin", "read_trace_bin",
           "read_trace_bin_header", "iter_trace_bin_chunks"]

BINARY_MAGIC = b"REPROTB\x00"
BINARY_VERSION = 1
DEFAULT_BIN_CHUNK_EDGES = 1 << 20

_DTYPES = {"src": "<i4", "dst": "<i4", "w": "<f8"}
_BIN_SUFFIXES = (".rtb", ".rtb.gz", ".rtb.zst", ".rtb.zstd")


class BinaryFormatError(ValueError):
    """A malformed `.rtb` container (binary sibling of TraceFormatError)."""

    def __init__(self, path, message: str):
        super().__init__(f"binary trace {os.fspath(path)!s}: {message}")
        self.path = os.fspath(path)


def is_binary_trace_path(source) -> bool:
    """True for paths the `.rtb` reader owns (incl. compressed)."""
    if not isinstance(source, (str, os.PathLike)):
        return False
    return os.fspath(source).endswith(_BIN_SUFFIXES)


def _open_bin(path, mode: str):
    p = os.fspath(path)
    if p.endswith(".gz"):
        import gzip
        return gzip.open(p, mode)
    if p.endswith((".zst", ".zstd")):
        try:
            import zstandard
        except ImportError as e:            # pragma: no cover - soft dep
            raise ImportError(
                "reading/writing .rtb.zst traces needs the optional "
                "'zstandard' package (pip install zstandard)") from e
        if "r" in mode:
            fh = open(p, "rb")
            return io.BufferedReader(
                zstandard.ZstdDecompressor().stream_reader(fh))
        fh = open(p, "wb")
        return zstandard.ZstdCompressor().stream_writer(fh, closefd=True)
    return open(p, mode)


# ---------------------------------------------------------------------- #
# writer
# ---------------------------------------------------------------------- #
def write_trace_bin(path, g: IRGraph, stats=None,
                    chunk_edges: int = DEFAULT_BIN_CHUNK_EDGES) -> int:
    """Serialize `g` (plus optional ingestion `stats`) to `path`.

    The graph's edge arrays are split into `chunk_edges`-sized chunks so
    readers (a sharded parser) can shard work without re-splitting
    lines.  Returns the number of chunks written.
    """
    chunk_edges = max(int(chunk_edges), 1)
    src = np.ascontiguousarray(g.src, dtype=np.dtype(_DTYPES["src"]))
    dst = np.ascontiguousarray(g.dst, dtype=np.dtype(_DTYPES["dst"]))
    w = np.ascontiguousarray(g.w, dtype=np.dtype(_DTYPES["w"]))
    m = int(src.shape[0])
    bounds = list(range(0, m, chunk_edges)) + [m]
    chunks = [{"edges": bounds[i + 1] - bounds[i]}
              for i in range(len(bounds) - 1)] if m else []
    header = {
        "schema_version": 0,
        "n": int(g.n),
        "edges": m,
        "name": g.name,
        "dtypes": dict(_DTYPES),
        "chunks": chunks,
    }
    if stats is not None:
        header["stats"] = stats.summary() if hasattr(stats, "summary") \
            else dict(stats)
    label_ids = None
    if g.node_labels is not None:
        table: dict = {}
        label_ids = np.empty(len(g.node_labels), np.int32)
        for i, lab in enumerate(g.node_labels):
            label_ids[i] = table.setdefault(lab, len(table))
        header["label_table"] = list(table)
    hdr = json.dumps(header, separators=(",", ":")).encode("utf-8")
    f = _open_bin(path, "wb")
    try:
        f.write(BINARY_MAGIC)
        f.write(struct.pack("<HI", BINARY_VERSION, len(hdr)))
        f.write(hdr)
        for i in range(len(bounds) - 1):
            lo, hi = bounds[i], bounds[i + 1]
            f.write(src[lo:hi].tobytes())
            f.write(dst[lo:hi].tobytes())
            f.write(w[lo:hi].tobytes())
        if label_ids is not None:
            f.write(label_ids.tobytes())
    finally:
        f.close()
    return max(len(chunks), 0)


# ---------------------------------------------------------------------- #
# reader
# ---------------------------------------------------------------------- #
def _read_exact(f, n: int, path, what: str) -> bytes:
    buf = f.read(n)
    if len(buf) != n:
        raise BinaryFormatError(
            path, f"truncated {what}: wanted {n} bytes, got {len(buf)}")
    return buf


def _read_header(f, path) -> dict:
    magic = f.read(len(BINARY_MAGIC))
    if magic != BINARY_MAGIC:
        raise BinaryFormatError(
            path, f"bad magic {magic[:8]!r} (expected {BINARY_MAGIC!r}); "
                  "not a .rtb binary trace")
    version, hlen = struct.unpack(
        "<HI", _read_exact(f, 6, path, "version/header-length"))
    if version != BINARY_VERSION:
        raise BinaryFormatError(
            path, f"unsupported format version {version} "
                  f"(this reader handles version {BINARY_VERSION})")
    try:
        header = json.loads(_read_exact(f, hlen, path, "header"))
    except ValueError as e:
        raise BinaryFormatError(path, f"header is not valid JSON: {e}") \
            from None
    if not isinstance(header, dict):
        raise BinaryFormatError(path, "header is not a JSON object")
    for field in ("n", "edges", "dtypes", "chunks"):
        if field not in header:
            raise BinaryFormatError(path, f"header missing field {field!r}")
    dtypes = header["dtypes"]
    for col, want in _DTYPES.items():
        got = dtypes.get(col)
        if got != want:
            raise BinaryFormatError(
                path, f"dtype mismatch for column {col!r}: file says "
                      f"{got!r}, this reader requires {want!r}")
    declared = sum(int(c["edges"]) for c in header["chunks"])
    if declared != int(header["edges"]):
        raise BinaryFormatError(
            path, f"chunk table sums to {declared} edges but header "
                  f"declares {header['edges']}")
    return header


def read_trace_bin_header(path) -> dict:
    """Parse and validate just the container header (cheap inspect)."""
    f = _open_bin(path, "rb")
    try:
        return _read_header(f, path)
    finally:
        f.close()


def _chunk_cols(f, path, m: int, i: int):
    cols = []
    for col in ("src", "dst", "w"):
        dt = np.dtype(_DTYPES[col])
        raw = _read_exact(f, m * dt.itemsize, path,
                          f"chunk {i} column {col!r}")
        cols.append(np.frombuffer(raw, dtype=dt))
    return tuple(cols)


def iter_trace_bin_chunks(path):
    """Yield `(header, src, dst, w)` per chunk — the dist sharding feed.

    The header is yielded with every chunk (same object) so consumers
    can size def-free merge state without a second pass; columns are
    read-only `np.frombuffer` views over freshly-read bytes.
    """
    f = _open_bin(path, "rb")
    try:
        header = _read_header(f, path)
        for i, c in enumerate(header["chunks"]):
            m = int(c["edges"])
            if m < 0:
                raise BinaryFormatError(path, f"chunk {i} negative size")
            yield (header,) + _chunk_cols(f, path, m, i)
        if not header["chunks"]:
            yield (header, np.zeros(0, np.int32), np.zeros(0, np.int32),
                   np.zeros(0, np.float64))
    finally:
        f.close()


def read_trace_bin(path, keep_labels: bool = False):
    """Load a `.rtb` container back into `(IRGraph, TraceStats)`.

    The graph is bit-identical to the one `convert` serialized (same
    dtypes, same edge order); `stats` are the conversion-time ingestion
    stats re-tagged with `engine="binary"` (or fresh zeroed stats when
    the writer had none).
    """
    from time import perf_counter

    from .. import obs
    from .ingest import TraceStats          # local import: no cycle at load
    t0 = perf_counter()
    f = _open_bin(path, "rb")
    try:
        header = _read_header(f, path)
        m = int(header["edges"])
        srcs, dsts, ws = [], [], []
        for i, c in enumerate(header["chunks"]):
            s, d, w = _chunk_cols(f, path, int(c["edges"]), i)
            srcs.append(s)
            dsts.append(d)
            ws.append(w)
        labels = None
        table = header.get("label_table")
        if table is not None:
            n = int(header["n"])
            ids = np.frombuffer(
                _read_exact(f, 4 * n, path, "label ids"), dtype="<i4")
            bad = (ids < 0) | (ids >= len(table))
            if bad.any():
                raise BinaryFormatError(
                    path, f"label id {int(ids[bad][0])} outside string "
                          f"table of {len(table)} entries")
            if keep_labels:
                labels = [table[i] for i in ids]
    finally:
        f.close()
    src = np.concatenate(srcs) if srcs else np.zeros(0, np.int32)
    dst = np.concatenate(dsts) if dsts else np.zeros(0, np.int32)
    w = np.concatenate(ws) if ws else np.zeros(0, np.float64)
    if src.shape[0] != m:                   # unreachable if header honest
        raise BinaryFormatError(path, "edge columns shorter than header")
    n = int(header["n"])
    if m and (int(src.max()) >= n or int(dst.max()) >= n):
        raise BinaryFormatError(
            path, f"edge endpoint exceeds declared vertex count {n}")
    g = IRGraph(n=n, src=src, dst=dst, w=w,
                name=header.get("name") or "trace", node_labels=labels)
    st = header.get("stats") or {}
    known = {f.name for f in TraceStats.__dataclass_fields__.values()} \
        if hasattr(TraceStats, "__dataclass_fields__") else set()
    stats = TraceStats(**{k: v for k, v in st.items() if k in known})
    stats.engine = "binary"
    if obs.enabled():
        t1 = perf_counter()
        try:
            nbytes = os.path.getsize(path)
        except OSError:
            nbytes = 0
        obs.complete("trace.ingest", t0, t1, engine="binary",
                     bytes=int(nbytes), edges=m,
                     edges_per_s=round(m / max(t1 - t0, 1e-9)))
    return g, stats
