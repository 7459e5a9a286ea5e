"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with as many CUDA devices as the
cell asks for.  The last line of standard output is one JSON object:
`correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end
metrics, or with --trace 1 its per-layer metrics), `device`, with
--trace 1 `breakdown`, and last `checks`, each compared number beside its
limit (also the last lines of standard error).  Without the devices, or
with JAX or the JAX package loaded, it exits with another code than 0
and prints no result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".portbench_cache")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    # every build and kernel cache of the program inside the checkout, at
    # fixed paths: the kernels build into build/repro_torch/ by themselves;
    # a Triton or cpp_extension kernel a later change adds finds its cache
    # here, since this file may not change then
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(CACHE, sub)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

    from portbench import harness
    cell = harness.load_cell(args.workload)

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s), found {n}", file=sys.stderr)
        return 2
    torch.set_num_threads(4)

    result = harness.execute(cell, args.seed, args.seconds, bool(args.trace),
                             "cuda", T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: modules of JAX or of the JAX package are "
              f"loaded: {found}", file=sys.stderr)
        return 3
    for line in harness.check_lines(result):
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
