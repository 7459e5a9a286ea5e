"""Readings that the limits of `correct` are set from, on the card at the
cell's own size, many seeds in one process.

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--fault-seeds 1,2,3]

For each seed it sets the program's run up as the benchmark does (a
prefill also runs its `check_requests` requests), runs the float32
reference once, and prints one JSON line: the compared numbers of the
program against the reference; with the seed among `--control-seeds`,
those of the control (the reference computed one precision below, TF32)
against it; with the seed among `--fault-seeds`, those of the program
with each planted fault of `faults.py`.  Not run by the benchmark.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ints(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def _worst_leaves(obs: dict, ref: dict, top: int = 3) -> dict:
    """The leaves with the largest gaps of the gradient and change norms,
    with the reference's norm of each and its median leaf's."""
    out = {}
    for key in ("grad_norms", "update_norms"):
        r = ref[key]
        med = sorted(r.values())[len(r) // 2]
        gaps = sorted(((abs(obs[key][p] - n) / max(n, med), "/".join(map(
            str, p)), n) for p, n in r.items()), reverse=True)[:top]
        out[key] = {"median": med, "top": gaps}
    return out


def observe(run, loop):
    """The program's observations for the comparison, its state freed."""
    driver = loop.Driver(run)
    if run.traffic["loop"] == "prefill":
        for _ in range(run.traffic["check_requests"]):
            driver.unit()
    obs = driver.observe()
    driver.release()
    return obs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_ints, required=True)
    ap.add_argument("--control-seeds", type=_ints, default=[])
    ap.add_argument("--fault-seeds", type=_ints, default=[])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch
    from portbench import control, faults, harness
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = harness.load_cell(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        run = harness.Run(cell, seed, args.device)
        loop = run.loop()
        obs = observe(run, loop)
        torch.cuda.empty_cache()
        ref = loop.reference(run, obs)
        line = {"seed": seed, "program": loop.compare(obs, ref)}
        if "losses" in obs:
            line["losses"] = {"program": obs["losses"],
                              "reference": ref["losses"]}
            line["worst_leaves"] = _worst_leaves(obs, ref)
        if seed in args.control_seeds:
            with control.lowered(args.device):
                low = loop.reference(run, obs)
            line["control"] = loop.compare(low, ref)
            if "losses" in low:
                line["losses"]["control"] = low["losses"]
                line["worst_leaves_control"] = _worst_leaves(low, ref)
        if seed in args.fault_seeds:
            for name, wrap in faults.FAULTS[run.traffic["loop"]].items():
                bad = harness.Run(cell, seed, args.device, wrap_step=wrap)
                line[name] = loop.compare(observe(bad, loop), ref)
                torch.cuda.empty_cache()
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
    print(json.dumps({"forbidden": harness.forbidden_modules()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
