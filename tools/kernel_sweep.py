"""What the kernel sweep tools share: building copies of a CUDA source,
reading the compiler's and the card's reports, and timing on the card.

Imported by `tools/rwkv6_sweep.py` and `tools/rglru_sweep.py`; it needs
nvcc and a CUDA device only when its functions are called.
"""
from __future__ import annotations

import collections
import ctypes
import os
import re
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "src"))

from repro_torch.core.cuda import _build  # noqa: E402

CSRC = os.path.join(HERE, "..", "src", "repro_torch", "csrc")


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def replace_once(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise RuntimeError(f"{old!r} is not in the source once")
    return text.replace(old, new)


def set_constants(text: str, source: dict, values) -> str:
    """`text` with each `constexpr int name = source[name];` set to the
    value at the same place in `values`."""
    for name, value in zip(source, values):
        text = replace_once(text, f"constexpr int {name} = {source[name]};",
                            f"constexpr int {name} = {value};")
    return text


def build(tmp: str, sources: dict, label=str) -> dict:
    """Compile each {key: CUDA source} into its own shared library with
    the library's flags, one nvcc each, all at once.  Returns {key: (path
    of the library, nvcc's output)} for those that built, and prints why
    the others did not, naming each by `label(key)`."""
    procs = {}
    for i, (key, text) in enumerate(sources.items()):
        path = os.path.join(tmp, f"v{i}.cu")
        with open(path, "w") as f:
            f.write(text)
        so = path[:-3] + ".so"
        procs[key] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", so, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for key, (so, proc) in procs.items():
        out, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            errors = [line for line in out.splitlines() if "error" in line]
            print(f"variant {label(key)}: does not build: {errors[:3]}",
                  flush=True)
            continue
        built[key] = (so, out)
    return built


def entry(so: str, name: str, argtypes: list):
    fn = getattr(ctypes.CDLL(so), name)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    return fn


def ptxas_report(log: str, name_part: str) -> str:
    """Registers and spills of the kernels whose mangled name holds
    `name_part`, from `-Xptxas -v`."""
    lines = log.splitlines()
    found = []
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and name_part in line:
            rest = " ".join(part.strip() for part in lines[i + 1:i + 4])
            regs = re.search(r"Used (\d+) registers", rest)
            spill = re.search(r"(\d+) bytes spill stores", rest)
            found.append(f"{regs.group(1) if regs else '?'} registers, "
                         f"{spill.group(1) if spill else '?'} bytes spill "
                         f"stores")
    return "; ".join(found) or "no report"


def sass_counts(so: str, name_part: str) -> str:
    """Instruction counts in the SASS (`cuobjdump -sass`, where the
    toolkit has it) of the kernels whose mangled name holds `name_part`:
    the whole kernel, and its longest run of code without a branch or a
    barrier (in an unrolled loop, the loop's body)."""
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if not os.path.exists(cuobjdump):
        return "cuobjdump not found"
    sass = subprocess.run([cuobjdump, "-sass", so], capture_output=True,
                          text=True, timeout=120).stdout
    out = []
    for func in re.split(r"\n\s*Function : ", sass)[1:]:
        name = func.split("\n", 1)[0].strip()
        if name_part not in name:
            continue
        ops = re.findall(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", func)
        runs, run = [], []
        for op in ops:
            run.append(op)
            if op.startswith(("BRA", "BAR", "EXIT")):
                runs.append(run)
                run = []
        longest = max(runs + [run], key=len)

        def mix(seq):
            kinds = collections.Counter(op.split(".")[0] for op in seq)
            return ", ".join(f"{k} {n}" for k, n in kinds.most_common(10))

        out.append(f"{name[:60]}: {len(ops)} instructions ({mix(ops)}); "
                   f"longest block {len(longest)} ({mix(longest)})")
    return "; ".join(out) or "no such kernel"


def cuda_ms(fn, reps: int) -> float:
    """CUDA events around `reps` calls after a warm-up, the card first
    sleeping ~0.1 s so that the host has queued every call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def clock_under_load(fn, seconds: float = 2.0) -> str:
    """The SM clock and power draw that nvidia-smi samples while `fn` runs
    back to back for about `seconds` (median of the samples)."""
    per = cuda_ms(fn, 5) / 1e3
    calls = max(1, int(seconds / per))
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    finally:
        smi.terminate()
        out, _ = smi.communicate(timeout=30)
    samples = [tuple(float(x) for x in line.split(","))
               for line in out.splitlines() if line.count(",") == 1]
    if not samples:
        return "no samples"
    clocks = sorted(s[0] for s in samples)
    power = sorted(s[1] for s in samples)
    return (f"SM clock {clocks[len(clocks) // 2]!r} MHz, power "
            f"{power[len(power) // 2]!r} W (median of {len(samples)} "
            f"samples over {calls} launches)")
