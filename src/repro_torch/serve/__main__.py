"""``python -m repro_torch.serve`` — the plan-service CLI.

Subcommands:

  plan   serve one request (cold on first call, cached after)::

             python -m repro_torch.serve plan trace.ndjson -p 64 \
                 --method wb_libra --lam 1.1 --cache-dir .cache/plans

  batch  serve a JSON file of requests through `plan_many`; each entry
         is ``{"source": path, "p": int, "method": ..., "lam": ...}``

  cache  list the fingerprints committed in a cache directory

  metrics  replay an optional JSON request list, then print the live
           `PlanService.metrics()` snapshot (hit rate, plans/s,
           plan-latency p50/p99, evictions)::

             python -m repro_torch.serve metrics requests.json \
                 --max-hot-entries 64

Cold plans run on the card by default (`--backend cuda --device cuda`);
`--device cpu` runs the kernels' plain versions, `--backend fast` the
host engine.  Hits touch neither.
"""
from __future__ import annotations

import argparse
import json
import sys

from .cache import PlanCache
from .service import DEFAULT_CACHE_DIR, PlanRequest, PlanService


def _parse_requests(entries) -> list:
    """JSON request entries -> PlanRequest list (shared by batch/metrics)."""
    return [PlanRequest(source=e["source"], p=int(e["p"]),
                        method=e.get("method", "wb_libra"),
                        lam=float(e.get("lam", 1.0)),
                        seed=int(e.get("seed", 0)),
                        edge_order=e.get("edge_order", "auto"),
                        weight_model=e.get("weight_model", "bytes"))
            for e in entries]


def _add_knobs(ap) -> None:
    ap.add_argument("-p", type=int, required=True, help="cluster count")
    ap.add_argument("--method", default="wb_libra")
    ap.add_argument("--lam", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--edge-order", default="auto",
                    choices=("auto", "trace", "shuffled"))
    ap.add_argument("--weight-model", default="bytes")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.serve")
    ap.add_argument("--cache-dir", default=DEFAULT_CACHE_DIR)
    ap.add_argument("--backend", default="cuda",
                    help="planning backend of cold plans (default cuda: "
                         "the reductions on the card's kernels)")
    ap.add_argument("--device", default="cuda",
                    help="where the cuda backend runs: cuda (the card, the "
                         "default) or cpu (the kernels' plain versions)")
    ap.add_argument("--max-hot-entries", type=int, default=None,
                    help="LRU bound on the in-memory hot map (entries)")
    ap.add_argument("--max-hot-bytes", type=int, default=None,
                    help="LRU bound on the in-memory hot map (bytes)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("plan", help="serve one plan request")
    s.add_argument("source", help="trace / .rtb / .npz path")
    _add_knobs(s)

    b = sub.add_parser("batch", help="serve a JSON request list")
    b.add_argument("requests", help="path to a JSON list of requests")

    sub.add_parser("cache", help="list committed plan fingerprints")

    m = sub.add_parser("metrics",
                       help="replay requests, print live service metrics")
    m.add_argument("requests", nargs="?", default=None,
                   help="optional JSON request list to replay first")

    args = ap.parse_args(argv)

    if args.cmd == "cache":
        for fp in PlanCache(args.cache_dir).fingerprints():
            print(fp)
        return 0

    svc = PlanService(cache_dir=args.cache_dir, backend=args.backend,
                      max_hot_entries=args.max_hot_entries,
                      max_hot_bytes=args.max_hot_bytes, device=args.device)
    if args.cmd == "metrics":
        if args.requests:
            with open(args.requests) as f:
                entries = json.load(f)
            svc.plan_many(_parse_requests(entries))
        print(json.dumps(svc.metrics(), indent=2, default=float))
        return 0
    if args.cmd == "plan":
        req = PlanRequest(source=args.source, p=args.p,
                          method=args.method, lam=args.lam,
                          seed=args.seed, edge_order=args.edge_order,
                          weight_model=args.weight_model)
        resp = svc.plan(req)
        print(json.dumps(resp.summary(), indent=2, default=float))
        return 0

    with open(args.requests) as f:
        entries = json.load(f)
    if not isinstance(entries, list):
        print("batch: the requests file must hold a JSON list",
              file=sys.stderr)
        return 1
    out = [r.summary() for r in svc.plan_many(_parse_requests(entries))]
    print(json.dumps({"responses": out, "stats": svc.stats()},
                     indent=2, default=float))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
