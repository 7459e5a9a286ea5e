"""Trace tooling CLI.

    python -m repro_torch.trace inspect  examples/traces/toy_loop.ndjson
    python -m repro_torch.trace convert  trace.ndjson graph.rtb
    python -m repro_torch.trace partition trace.ndjson -p 64 --method wb_libra
    python -m repro_torch.trace record   mlp.ndjson --program mlp
    python -m repro_torch.trace synth    big.ndjson --lines 1000000 --seed 0

`inspect` prints ingestion stats + graph stats as JSON; `convert` writes
a `.rtb` binary trace or an `.npz` IRGraph snapshot; `partition` runs
the full partition -> map -> simulate pipeline on the ingested graph and
prints the plan summary, on the card by default (`--device cpu` runs
the kernels' plain versions, `--backend fast` the host engine;
`--workers W` > 1 parses on W sharded workers and cuts with the host
`dist` backend); `record` captures a built-in PyTorch demo program's
dynamic trace, on the card by default (`--device cpu` runs it on the
host); `synth` writes a deterministic synthetic trace.
"""
from __future__ import annotations

import argparse
import json
import sys

from .ingest import ingest_trace_with_stats, replay_trace
from .record import DEMO_PROGRAMS, demo_program, record_fn
from .synth import synthesize_trace
from .weights import WEIGHT_MODELS


def _add_ingest_args(sp) -> None:
    sp.add_argument("trace",
                    help="NDJSON trace file (.gz / .zst paths are "
                         "decompressed transparently; no flag needed) or "
                         "a .rtb binary trace from `convert`")
    sp.add_argument("--weight-model", default="bytes",
                    choices=sorted(WEIGHT_MODELS))
    sp.add_argument("--on-error", default="raise",
                    choices=("raise", "skip"))
    sp.add_argument("--chunk-edges", type=int, default=1 << 16)
    sp.add_argument("--cfg", default=None,
                    help="CFG NDJSON side file (block/edge/path records)")
    sp.add_argument("--replay", action="store_true",
                    help="treat the trace as a static listing and replay "
                         "it along the CFG's path records")
    sp.add_argument("--repeat", type=int, default=1,
                    help="replay each path this many times")
    sp.add_argument("--workers", type=int, default=1,
                    help="parse (and for `partition`, also cut) the trace "
                         "on this many sharded workers (repro_torch.dist); "
                         "1 = the sequential streaming ingester")


def _ingest(args, keep_labels: bool = False):
    kw = dict(weight_model=args.weight_model, on_error=args.on_error,
              chunk_edges=args.chunk_edges, keep_labels=keep_labels)
    if args.replay:
        if args.cfg is None:
            sys.exit("--replay needs --cfg (path records)")
        return replay_trace(args.trace, args.cfg, repeat=args.repeat, **kw)
    if args.workers > 1:
        from ..dist import dist_ingest_with_stats
        return dist_ingest_with_stats(args.trace, workers=args.workers,
                                      cfg=args.cfg, **kw)
    return ingest_trace_with_stats(args.trace, cfg=args.cfg, **kw)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.trace",
                                 description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("inspect", help="ingest + print stats JSON")
    _add_ingest_args(sp)

    sp = sub.add_parser("convert",
                        help="ingest + save a .rtb binary trace or .npz "
                             "IRGraph snapshot (picked by suffix)")
    _add_ingest_args(sp)
    sp.add_argument("out", help="output path: .rtb[.gz|.zst] writes the "
                                "binary columnar trace container v1; "
                                ".npz writes an IRGraph snapshot")

    sp = sub.add_parser("partition",
                        help="ingest + partition/map/simulate summary")
    _add_ingest_args(sp)
    sp.add_argument("-p", "--clusters", type=int, default=8)
    sp.add_argument("--method", default="wb_libra")
    sp.add_argument("--lam", type=float, default=1.0)
    sp.add_argument("--backend", default="cuda",
                    help="pipeline backend (default cuda: the reductions "
                         "on the card's kernels)")
    sp.add_argument("--device", default="cuda",
                    help="where the cuda backend runs: cuda (the card, the "
                         "default) or cpu (the kernels' plain versions)")
    sp.add_argument("--divergence", type=float, default=None,
                    help="adaptive merge trigger for the dist backend: "
                         "defer full state merges until the per-cluster "
                         "load drift exceeds this fraction of the mean "
                         "cluster load (default: merge every round)")
    sp.add_argument("--profile", default=None, metavar="OUT.json",
                    help="write a Perfetto-loadable telemetry profile of "
                         "the ingest+partition run (render with `python "
                         "-m repro_torch.obs summarize OUT.json`)")

    sp = sub.add_parser("record",
                        help="write a PyTorch demo program's trace as "
                             "NDJSON")
    sp.add_argument("out", help="output .ndjson path")
    sp.add_argument("--program", default="mlp",
                    choices=sorted(DEMO_PROGRAMS))
    sp.add_argument("--device", default="cuda",
                    help="where the program runs: cuda (the card, the "
                         "default) or cpu")

    sp = sub.add_parser("synth", help="write a synthetic NDJSON trace")
    sp.add_argument("out", help="output .ndjson path")
    sp.add_argument("--lines", type=int, default=100_000)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--fns", type=int, default=4)

    args = ap.parse_args(argv)

    if args.cmd == "inspect":
        g, stats = _ingest(args, keep_labels=False)
        print(json.dumps({"stats": stats.summary(), "graph": g.stats()},
                         indent=2, default=float))
    elif args.cmd == "convert":
        from .binfmt import is_binary_trace_path, write_trace_bin
        g, stats = _ingest(args)
        if is_binary_trace_path(args.out):
            write_trace_bin(args.out, g, stats)
        else:
            g.save_npz(args.out)
        print(f"wrote {args.out}: {g.num_vertices} vertices, "
              f"{g.num_edges} edges ({stats.records} records)")
    elif args.cmd == "partition":
        import contextlib

        from .. import obs
        from ..core.planner import plan_graph
        prof = (obs.profiled(args.profile) if args.profile
                else contextlib.nullcontext())
        with prof:
            g, _ = _ingest(args)
            backend = "dist" if args.workers > 1 else args.backend
            report = plan_graph(g, args.clusters, method=args.method,
                                lam=args.lam, backend=backend,
                                workers=args.workers,
                                divergence=args.divergence,
                                device=args.device)
        print(json.dumps(report.summary(), indent=2, default=float))
        if args.profile:
            print(f"profile: {args.profile} (python -m repro_torch.obs "
                  f"summarize {args.profile})", file=sys.stderr)
    elif args.cmd == "record":
        fn, fargs = demo_program(args.program, device=args.device)
        lines = record_fn(fn, *fargs, out=args.out, name=args.program)
        print(f"wrote {args.out}: {lines} trace lines ({args.program})")
    elif args.cmd == "synth":
        lines = synthesize_trace(args.out, args.lines, seed=args.seed,
                                 n_fns=args.fns)
        print(f"wrote {args.out}: {lines} synthetic trace lines "
              f"(seed {args.seed})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
