"""Readings from which the limits of ``correct`` are set, for one cell.

    python3 benchmark/calibrate.py --workload <name> --seeds 1 2 3 ... [--seconds 3]
                                   [--control] [--out FILE]

For each seed, in one process: a run of the cell as ``benchmark/run.py``
makes it (a short window), whose compared numbers are the program's readings;
with ``--control``, the same numbers for the control, the plain reference in
float8 (``benchmark/reference/control.py``) put in the program's place, on the seed's sampled inputs; with
``--faults``, a training cell's faults planted in the reference. One JSON line a seed and side, also appended to
``--out``. The readings and the limits set from them are in ``PERF.md``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", action="store_true",
                    help="also the faults' readings (training cells), planted in the reference")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import importlib

    import torch

    from benchmark.harness import core
    from benchmark.reference.control import Float8

    bench = core.load_json("BENCHMARK.json")
    cell, conf, mix = core.resolve(bench, args.workload)
    runner = importlib.import_module(f"benchmark.harness.{mix['kind']}_cell")

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    t = T_START
    for seed in args.seeds:
        run = core.Run(bench, cell, conf, mix, seed, args.seconds, False)
        out = runner.run(run, t)
        emit({"workload": args.workload, "seed": seed, "side": "program",
              "numbers": out["numbers"], "correct": out["correct"], "setup_s": out["setup_s"],
              "e2e": out["e2e"]})
        if args.control:
            run = core.Run(bench, cell, conf, mix, seed, args.seconds, False)
            emit({"workload": args.workload, "seed": seed, "side": "control",
                  "numbers": runner.control_numbers(run, out, Float8)})
        if args.faults and hasattr(runner, "fault_numbers"):
            run = core.Run(bench, cell, conf, mix, seed, args.seconds, False)
            for side, numbers in runner.fault_numbers(run, out).items():
                emit({"workload": args.workload, "seed": seed, "side": side, "numbers": numbers})
        del out
        torch.cuda.empty_cache()
        t = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
