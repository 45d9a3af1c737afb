"""The benchmark of fastga_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout, on a machine with the cards the cell
asks for.  Prints the run's numbers on stderr, the numbers compared with
their limits as its last lines there, and one JSON object as the last
line of stdout.  Exits 2, printing no result, without a CUDA card (or with
fewer than the cell asks for) or when a module of JAX or of the JAX
package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [HERE, ROOT]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from core import spec
    cell, config = spec.cell(ROOT, args.workload)[:2]
    # the configuration's process environment (thread pools), before
    # numpy and torch load
    os.environ.update(config.get("environment", {}))
    from core import harness
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        harness.log(f"benchmark: the cell needs {cell['chips']} CUDA "
                    f"card(s); torch sees "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result = harness.run(ROOT, args.workload, args.seed, args.seconds,
                         bool(args.trace), t_start=T_START)
    bad = harness.forbidden_modules()
    if bad:
        harness.log(f"benchmark: modules of JAX or the JAX package were "
                    f"loaded: {bad}")
        return 2
    sys.stdout.write(json.dumps(result) + "\n")
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
