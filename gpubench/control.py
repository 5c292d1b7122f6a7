"""The readings the limits are set from, on the card, in one process.

    python3 -m gpubench.control --workload CELL --seeds 1,2,3,4 \
        --control-seeds 1,2,3 --seconds 4

For each seed: a run of the cell with a short window and the port's
numbers (the lower readings).  For the seeds also in ``--control-seeds``:
the control's numbers on the same checked calls and on its own run from
the start (the upper readings: the reference in the port's place a step
below the stated precisions, the system's ``control``), and the port's
with the fault its system plants, where it has one (``fault``; the
flagship's: in a lagged cell, frame F - 1's samples pushed for every
frame).
Prints one JSON line per seed, then the largest lower and the smallest
upper reading of each number and whether the control comes out not
correct under the cell's limits.  The benchmark's own runs never run the
control.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys

from gpubench import check, run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m gpubench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=4.0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("gpubench.control: needs a CUDA card", file=sys.stderr)
        return 3
    root = os.getcwd()
    with_control = {int(s) for s in args.control_seeds.split(",") if s}
    lower, upper, fault, ctl_ok = {}, {}, {}, []
    for seed in (int(s) for s in args.seeds.split(",")):
        r = run.execute(root, args.workload, seed, args.seconds, False,
                        control=seed in with_control)
        w = r["window"]
        rec = {"seed": seed, "correct": r["correct"], "calls": w.calls,
               "checked": r["checked_calls"], "check_s": r["check_s"],
               "program": r["worst"], "control": r.get("control_worst"),
               "fault": r.get("fault_worst"),
               "frames_per_s": w.calls * r["cell"].spec["engine"]["streams"]
               * r["cell"].traffic.frames_per_call / w.window_s,
               "tracked_end": r["tracked_end"]}
        print(json.dumps(rec), flush=True)
        for k, v in r["worst"].items():
            lower[k] = max(lower.get(k, -1.0), v)
        for key, into in (("control_worst", upper), ("fault_worst", fault)):
            for k, v in (r.get(key) or {}).items():
                into[k] = min(into.get(k, float("inf")), v)
        if r.get("control_worst"):
            ctl_ok.append(check.verdict(r["control_worst"], r["limits"])[0])
        del r
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps({"lower": lower, "upper": upper, "fault": fault,
                      "control_correct": ctl_ok}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
