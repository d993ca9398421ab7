"""``python3 -m vdbbench --workload <name> --seed <n> --seconds <s> --trace
<0|1>``: one run of one cell of ``BENCHMARK.json``. Exits with 3 and no
result where the card or the cards that the cell asks for are missing,
and with 4 where JAX or the JAX package is loaded after the window."""

import time

_T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402


def _process_start() -> float:
    """``time.perf_counter`` at this process's start (its
    ``/proc/self/stat`` start time, to 10 ms), or at this module's
    import where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        age = time.clock_gettime(time.CLOCK_BOOTTIME) - started
        return time.perf_counter() - age
    except (OSError, ValueError, IndexError, AttributeError):
        return _T_IMPORT


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def main(argv=None) -> int:
    t_start = _process_start()
    ap = argparse.ArgumentParser(prog="python3 -m vdbbench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from .manifest import Cell, load_manifest
    cell = Cell(args.workload, load_manifest())
    import torch
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell.chips):
        print(f"vdbbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 3
    from . import harness
    out = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda", t_start)
    found = harness.forbidden_modules()
    if found:
        print(f"vdbbench: loaded after the window: {', '.join(found)}",
              file=sys.stderr)
        return 4
    out["device"]["power_limit"] = _power_limit()
    notes = {key: out.pop(key) for key in list(out) if key.startswith("_")}
    print(f"vdbbench: {args.workload} seed {args.seed}: "
          f"{json.dumps(notes)}", file=sys.stderr)
    print(f"correct {out['correct']}", file=sys.stderr)
    for name, c in out["checks"].items():
        ok = (c["value"] <= c["limit"] if c["is"] == "max"
              else c["value"] >= c["limit"])
        print(f"check {name} {c['value']!r} {c['is']} {c['limit']!r} "
              f"{'ok' if ok else 'FAIL'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
