"""Multi-pod dry run: run every (architecture × input-shape) cell's step
once on the production meshes, on fake tensors, and record its per-rank
memory, FLOPs and collectives.

The port of `repro.launch.dryrun`.  Usage, with PYTHONPATH=src:
    python -m repro_torch.launch.dryrun              # all cells
    python -m repro_torch.launch.dryrun --arch smollm-360m
    python -m repro_torch.launch.dryrun --multi-pod --shape train_4k
    python -m repro_torch.launch.dryrun --out results.json

The JAX package stands 512 placeholder host devices in for the 2×16×16
pod slice and compiles each cell; here this process is rank 0 of a fake
process group of 512 ranks (`launch.mesh.fake_world`: collectives return
at once), each cell's inputs are fake tensors (`FakeTensorMode`) placed
on the mesh as DTensors, and the step runs once under
`analysis.analyze_program`.  Every number is rank 0's, as the JAX
analyzer's are one device's.

`--impl cuda` (the default) runs the card's path: each kernel call is
one region, charged its function's work, whose outputs (and what its
forward keeps for the backward) are allocated as the kernel's wrapper
allocates them and not computed, fake tensors holding no data.  So the
memory is the card's, and a cell costs its operators, not the plain
versions' (the RG-LRU's plain version is a loop over time: at 4,096
tokens ~100,000 fake operators a layer, hours for recurrentgemma-9b's
train cell).  `--impl auto` runs the plain versions, the CPU's
dispatch.  The
records have the JAX dry run's keys, so one reader takes both files; a
key with no counterpart (`compile_s`, `bytes_accessed`,
`generated_code_bytes`) is -1, as the JAX dry run writes a number it
cannot read.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

__all__ = ["collective_bytes", "run_cell"]


def collective_bytes(cost) -> dict:
    """The collectives of a run (`analysis.ProgramCost`) as the JAX dry
    run's record: bytes and counts per op under the JAX names, and their
    total."""
    ops = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
           "collective-permute")
    totals = {op: 0.0 for op in ops}
    counts = {op: 0 for op in ops}
    for op, b in cost.collective_bytes.items():
        totals[op] = totals.get(op, 0.0) + b
        counts[op] = counts.get(op, 0) + cost.collective_counts[op]
    return {"bytes": totals, "counts": counts,
            "total_bytes": sum(totals.values())}


def run_cell(cell, mesh, multi_pod: bool, impl: str = "cuda",
             par_override: dict | None = None,
             n_layers: int | None = None) -> dict:
    from repro_torch.analysis import analyze_program
    from repro_torch.launch.cells import lower_cell
    t0 = time.time()
    prepared, meta = lower_cell(cell, mesh, impl=impl,
                                par_override=par_override,
                                n_layers=n_layers)
    with prepared.context():
        cost = analyze_program(prepared.step, *prepared.args)
    t_run = time.time() - t0
    coll = collective_bytes(cost)
    rec = {
        **meta,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "ok": True,
        "lower_s": round(t_run, 1),
        "compile_s": -1,
        "flops": cost.flops,
        "bytes_accessed": -1,
        "hlo_flops": cost.flops,
        "hlo_hbm_bytes": cost.hbm_bytes,
        "hlo_collective_bytes": cost.collective_bytes,
        "hlo_collective_bytes_bf16eq": cost.collective_bytes_bf16eq,
        "hlo_collective_counts": cost.collective_counts,
        "collectives": coll,
        "memory": {
            "argument_bytes": prepared.argument_bytes,
            "output_bytes": -1,
            "temp_bytes": max(0, int(cost.peak_bytes)),
            "generated_code_bytes": -1,
        },
    }
    print(f"  memory: args={rec['memory']['argument_bytes'] / 1e9:.2f}GB "
          f"temps={rec['memory']['temp_bytes'] / 1e9:.2f}GB (rank 0 of "
          f"{mesh.size()})")
    print(f"  cost: flops={cost.flops:.3e} hbm={cost.hbm_bytes:.3e} "
          f"coll={cost.total_collective_bytes:.3e} "
          f"{cost.collective_counts} ({t_run:.1f} s)", flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default=None, help="only this architecture")
    ap.add_argument("--shape", default=None, help="only this shape")
    ap.add_argument("--multi-pod", action="store_true",
                    help="2x16x16 (512-rank) mesh instead of 16x16")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="dryrun_results.json")
    ap.add_argument("--impl", default="cuda",
                    help="cuda: the kernels as regions (default); auto: "
                         "the plain versions")
    args = ap.parse_args(argv)

    from repro_torch.launch.cells import cell_skip_reason, enumerate_cells
    from repro_torch.launch.mesh import fake_world, make_production_mesh

    cells = enumerate_cells(include_skipped=True)
    if args.arch:
        cells = [c for c in cells if c.arch == args.arch]
    if args.shape:
        cells = [c for c in cells if c.shape == args.shape]

    mesh_flags = [args.multi_pod] if not args.both_meshes else [False, True]
    results = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {(r["cell"], r["mesh"]) for r in results if r.get("ok")}

    failures = 0
    with fake_world(512 if any(mesh_flags) else 256):
        for multi_pod in mesh_flags:
            mesh = make_production_mesh(multi_pod=multi_pod,
                                        device_type="cpu")
            mname = "2x16x16" if multi_pod else "16x16"
            for cell in cells:
                if (cell.name, mname) in done:
                    print(f"[skip-done] {cell.name} on {mname}")
                    continue
                reason = cell_skip_reason(cell)
                if reason:
                    print(f"[skip] {cell.name}: {reason}")
                    results.append({"cell": cell.name, "mesh": mname,
                                    "ok": None, "skip_reason": reason})
                    continue
                print(f"[run ] {cell.name} on {mname} ...", flush=True)
                try:
                    results.append(run_cell(cell, mesh, multi_pod,
                                            impl=args.impl))
                except Exception as e:  # noqa: BLE001 — record, continue
                    failures += 1
                    print(f"  FAILED: {type(e).__name__}: {e}")
                    traceback.print_exc(limit=3)
                    results.append({"cell": cell.name, "mesh": mname,
                                    "ok": False,
                                    "error": f"{type(e).__name__}: {e}"})
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)
    with open(args.out, "w") as f:      # the skips after the last run too
        json.dump(results, f, indent=1)
    print(f"\n{sum(1 for r in results if r.get('ok'))} ok, "
          f"{failures} failed -> {args.out}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
