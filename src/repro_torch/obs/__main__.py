"""``python -m repro_torch.obs summarize out.json`` — render a profile.

Prints the phase table (count, total, mean, % wall, critical-path
contribution), the wall-time decomposition into parallel / serial /
idle, per-lane utilization, and the measured serial fraction with its
Amdahl speedup bound.

``python -m repro_torch.obs timeline BENCH_dist_scaling.json -o tl.json``
reconstructs a Perfetto-loadable trace from the dist round timeline
persisted in a bench JSON's meta (``meta.timeline_w4`` by default) —
one labelled track per cut worker plus the coordinator lane.
"""

from __future__ import annotations

import argparse
import json
import sys

from .export import events_from_chrome, load_profile, timeline_trace
from .summarize import render_summary, summarize_events


def _timeline(args) -> int:
    with open(args.source, "r", encoding="utf-8") as fh:
        doc = json.load(fh)
    tl = doc
    if "rounds" not in tl:                  # a bench JSON, not a raw dict
        tl = doc.get("meta", {}).get(args.key)
    if not tl or not tl.get("rounds"):
        print(f"{args.source}: no round timeline under meta.{args.key}",
              file=sys.stderr)
        return 1
    trace = timeline_trace(tl)
    with open(args.out, "w", encoding="utf-8") as fh:
        json.dump(trace, fh, separators=(",", ":"))
        fh.write("\n")
    n = sum(1 for ev in trace["traceEvents"] if ev.get("ph") == "X")
    print(f"{args.out}: {n} spans over {len(tl['rounds'])} rounds "
          f"(open in ui.perfetto.dev)")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs")
    sub = ap.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("summarize", help="render a profile JSON as a phase table")
    s.add_argument("profile", help="path written by REPRO_PROFILE / profile=")
    t = sub.add_parser(
        "timeline", help="dist round timeline -> Perfetto trace JSON")
    t.add_argument("source", help="BENCH_dist_scaling.json or a raw "
                                  "timeline dict")
    t.add_argument("-o", "--out", default="timeline_trace.json")
    t.add_argument("--key", default="timeline_w4",
                   help="meta key holding the timeline (default "
                        "timeline_w4)")
    args = ap.parse_args(argv)

    if args.cmd == "timeline":
        return _timeline(args)

    doc = load_profile(args.profile)
    events = events_from_chrome(doc)
    if not events:
        print(f"{args.profile}: no events", file=sys.stderr)
        return 1
    counters = doc.get("repro", {}).get("counters", {})
    print(f"profile: {args.profile}  ({len(events)} events)")
    print(render_summary(summarize_events(events), counters))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
