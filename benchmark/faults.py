"""Readings of the control and the planted faults at a cell's own size.

    python3 benchmark/faults.py --workload <name> --seeds <n>,<n>,... \
        [--faults masks_off,diffs_added,ends_cut] [--seconds 1]

Runs the cell once a seed and fault (one job or more, the reference over
them) on the card, with the fault in place under the timed path, and
prints a JSON line a run: the workload, seed, fault, ``correct`` and every
number compared.  The benchmark's own runs never plant a fault.
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [HERE, ROOT]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--faults",
                    default="masks_off,diffs_added,ends_cut")
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    from core import spec
    os.environ.update(spec.cell(ROOT, args.workload)[1].get("environment",
                                                          {}))
    from core import faults, harness
    for seed in (int(s) for s in args.seeds.split(",")):
        for name in args.faults.split(","):
            with faults.FAULTS[name]():
                r = harness.run(ROOT, args.workload, seed, args.seconds,
                                False)
            print(json.dumps(dict(
                workload=args.workload, seed=seed, fault=name,
                correct=r["correct"], jobs=r["attempted"],
                checks={k: v["value"] for k, v in r["checks"].items()})),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
