"""Run one cell of ``BENCHMARK.json`` once on the card and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``; ``checks`` last: each number compared with its limit); the
same checks are the last lines of standard error.  With ``--trace 0`` the
metrics are the cell's end-to-end ones, with ``--trace 1`` its per-layer
ones.  The run exits non-zero, printing no result, where there is no CUDA
card or fewer than the cell asks for, or where a JAX module was loaded.
"""
import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(
        os.path.abspath(__file__)):
    sys.path.pop(0)           # not this folder's files as top-level modules
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    import argparse
    import json

    import torch

    from portbench import harness

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    cell = harness.load_cell(a.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{a.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    line = harness.run_cell(cell, a.seed, a.seconds, bool(a.trace),
                            torch.device("cuda", 0), T_START)
    found = harness.forbidden_modules()
    if found:
        print("JAX modules loaded: " + ", ".join(found), file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
