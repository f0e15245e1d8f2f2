"""Readings that a cell's limits are set from, on the card, in one process.

    python3 portbench/calibrate.py --workload <cell> --seconds <s> \
        --seeds <n> ... --control-seeds <n> ...

For every seed it runs the cell as ``run.py`` does (with a short window)
and prints the numbers its check compares; on the control seeds it also
reads the controls that have to fail the check: for a restore cell the
reference computed in fp8 (the precision below the cell's bf16), for a
training cell the program's own bf16 path (``mixed_precision``) run in the
float32 cell's place, and the fault of half of each batch left out of the
mean.  The last line summarises, for each number, the largest reading of
the program (the lower reading of its limit) and the smallest of each
control (the upper).
"""
import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(
        os.path.abspath(__file__)):
    sys.path.pop(0)
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    import argparse
    import copy
    import json

    import torch

    from portbench import harness

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cell = harness.load_cell(a.workload)
    lower, upper = {}, {}

    def note(table, name, value, pick):
        table[name] = pick(table.get(name, value), value)

    for seed in a.seeds:
        ctl = seed in a.control_seeds
        line = harness.run_cell(cell, seed, a.seconds, False, dev,
                                time.perf_counter(), controls=ctl)
        rec = {"seed": seed, "correct": line["correct"],
               "checks": {k: v["value"] for k, v in line["checks"].items()},
               "extra": {k: v for k, v in line.items()
                         if k not in ("correct", "attempted", "failed",
                                      "metrics", "device", "checks")}}
        for k, v in rec["checks"].items():
            note(lower, k, v, max)
        for k, v in rec["extra"].pop("not_compared", {}).items():
            note(lower, f"not_compared.{k}", v, max)
        for k, v in rec["extra"].items():
            if isinstance(v, dict):
                for kk, vv in v.items():
                    note(upper, f"{k}.{kk}", vv, min)
            elif isinstance(v, float):
                note(upper, k, v, min)
        if ctl and cell.traffic.get("dtype") == "float32":
            low = copy.deepcopy(cell)
            low.traffic["dtype"] = "bfloat16"
            cl = harness.run_cell(low, seed, a.seconds, False, dev,
                                  time.perf_counter())
            rec["bf16_program"] = {k: v["value"]
                                   for k, v in cl["checks"].items()}
            for k, v in rec["bf16_program"].items():
                note(upper, f"bf16_program.{k}", v, min)
        print(json.dumps(rec), flush=True)
    print(json.dumps({"workload": a.workload, "seeds": len(a.seeds),
                      "lower": lower, "upper": upper}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
