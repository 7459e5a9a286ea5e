"""PyTorch program -> NDJSON trace exporter (the round-trip oracle's write
side): the JAX package's `trace/record.py`, ported.

`record_graph` serializes a trace-ordered `IRGraph` (as built by
`core.op_graph.trace_to_graph`, or by the JAX package's jaxpr builder)
into TRACE_SCHEMA v0 NDJSON such that re-ingesting the file reproduces
the graph **bit-identically** — same vertex ids, same `src`/`dst` edge
stream, same weights under the `bytes` model.  It is host code, copied
from the JAX package and held to it byte for byte by the tests; any
captured program is also an NDJSON trace, and
`ingest_trace(record(...))` must equal `trace_to_graph(...)` exactly.

Exactness hinges on reproducing the graph builder's vertex *creation
order*.  The ingester creates, per record: the instruction vertex, then
one fresh vertex per `const:*` use and per first-use of an undefined id
(registered).  The capture creates, per operator: the operator's vertex,
then a free vertex inside its operand loop for each tensor not seen
before — the same order.  So every vertex serializes as its own record
in id order, *except* an in-degree-0 vertex whose first consumer
precedes it in id order (it was created inside that consumer's operand
loop): it is rendered inline — as a `const:*` use when it has a single
consumer, or as a plain undefined id when shared (a free/boundary
value), which the rolling def-table registers on first use.

Weights are carried in `use_tys` as `[N x i8]` byte types, so any v0
consumer reads them back with plain type parsing.

`DEMO_PROGRAMS` are the JAX package's three demo programs written in
PyTorch, with its shapes, on a `device=` ("cuda", the card, by default;
"cpu" for the host).
"""
from __future__ import annotations

import json
import math
import os

import torch

from ..core.cuda import resolve_device
from ..core.graph import IRGraph
from ..core.op_graph import trace_to_graph
from .schema import encode_bytes_type

__all__ = ["record_graph", "record_fn", "demo_program", "DEMO_PROGRAMS"]


def _json_str(s: str) -> str:
    return json.dumps(s, ensure_ascii=True)


def record_graph(g: IRGraph, out) -> int:
    """Write `g` as TRACE_SCHEMA v0 NDJSON; returns lines written.

    `g` must carry `node_labels` and be in trace order (consumers never
    precede their producers' records) — true of `trace_to_graph` output.
    Raises ValueError when the edge stream cannot be serialized
    id-exactly (e.g. a hand-built graph with forward dependencies).
    """
    if isinstance(out, (str, os.PathLike)):
        with open(out, "w", encoding="utf-8") as f:
            return record_graph(g, f)
    if g.node_labels is None:
        raise ValueError("record_graph needs node_labels "
                         "(use trace_to_graph / keep_labels=True)")
    n = g.num_vertices
    src = g.src.tolist()
    dst = g.dst.tolist()
    w = g.w.tolist()
    in_edges: list = [[] for _ in range(n)]
    out_deg = [0] * n
    first_consumer = [None] * n
    first_out_w = [8.0] * n
    for e in range(len(src)):
        s, d = src[e], dst[e]
        in_edges[d].append(e)
        if out_deg[s] == 0:
            first_consumer[s] = d
            first_out_w[s] = w[e]
        out_deg[s] += 1

    # vertices created inside an earlier consumer's operand loop
    inline_const = set()        # single-use literals -> const:* operand
    forward_reg = set()         # shared free/boundary vars -> undefined id
    for k in range(n):
        if (not in_edges[k] and first_consumer[k] is not None
                and first_consumer[k] < k):
            (inline_const if out_deg[k] == 1 else forward_reg).add(k)

    fn = str(g.name).replace(":", "_") or "trace"
    fn_j = _json_str(fn)
    lines = 0
    for k in range(n):
        if k in inline_const or k in forward_reg:
            continue
        uses, use_tys = [], []
        for e in in_edges[k]:
            s = src[e]
            if s in inline_const:
                uses.append(f"const:i64:{s}")
            elif s < k or s in forward_reg:
                # forward_reg ids are undefined at their first (earlier)
                # consumer, which makes the ingester materialise them at
                # exactly the original creation point
                uses.append(f"v{s}")
            else:
                raise ValueError(
                    f"edge {s}->{k} runs against trace order; graph is "
                    "not id-exactly serializable")
            use_tys.append(encode_bytes_type(w[e]))
        parts = [f'"fn":{fn_j},"bb":"bb0","pp":{_json_str(f"{fn}:bb0:i{lines}")}',
                 f'"op":{_json_str(g.node_labels[k])}',
                 f'"def":"v{k}"',
                 '"uses":[' + ",".join(_json_str(u) for u in uses) + "]"]
        if use_tys:
            parts.append(
                '"use_tys":[' + ",".join(_json_str(t) for t in use_tys) + "]")
        if out_deg[k]:
            parts.append(
                f'"def_ty":{_json_str(encode_bytes_type(first_out_w[k]))}')
        out.write("{" + ",".join(parts) + "}\n")
        lines += 1
    return lines


def record_fn(fn, *args, out, name: str | None = None, **kw) -> int:
    """Capture one run of a PyTorch function and write its dynamic trace
    as NDJSON; returns lines written."""
    g = trace_to_graph(fn, *args, name=name, **kw)
    return record_graph(g, out)


# ---------------------------------------------------------------------- #
# small built-in programs (CLI `record`, round-trip tests)
# ---------------------------------------------------------------------- #
def _ones(device, *shape):
    return torch.ones(shape, dtype=torch.float32,
                      device=resolve_device(device))


def _mlp(device="cuda"):
    def mlp(x, w1, w2):
        h = torch.tanh(x @ w1)
        return torch.sum(h @ w2)

    return mlp, (_ones(device, 4, 8), _ones(device, 8, 16),
                 _ones(device, 16, 4))


def _attention(device="cuda"):
    def attn(q, k, v):
        s = q @ k.T / math.sqrt(q.shape[-1])
        return torch.softmax(s, dim=-1) @ v

    return attn, tuple(_ones(device, 6, 8) for _ in range(3))


def _scan_rnn(device="cuda"):
    def rnn(xs, w):
        h = torch.zeros(xs.shape[1], dtype=xs.dtype, device=xs.device)
        ys = []
        for x in xs:                # the scan, one vertex set a step
            h = torch.tanh(h @ w + x)
            ys.append(h)
        return torch.stack(ys).sum()

    return rnn, (_ones(device, 5, 4), _ones(device, 4, 4))


DEMO_PROGRAMS = {"mlp": _mlp, "attention": _attention, "scan_rnn": _scan_rnn}


def demo_program(name: str, device="cuda"):
    """Return (fn, args) for a named built-in demo program, its tensors
    on `device`."""
    try:
        make = DEMO_PROGRAMS[name]
    except KeyError:
        raise ValueError(f"unknown demo program {name!r}; choose from "
                         f"{sorted(DEMO_PROGRAMS)}") from None
    return make(device)
