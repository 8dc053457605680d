"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is the entry of ``BENCHMARK.json``'s ``workloads`` named
``--workload``: its configuration (``configs`` -> the file under
``benchmark/configs/``) and traffic mix (``benchmark/traffic/<traffic>.json``,
whose ``kind`` picks the runner ``benchmark/harness/<kind>_cell.py``). The
run builds the port (``richsem_tpu_torch``) with weights and inputs drawn from
``--seed``, warms up, measures for ``--seconds``, and checks a sample of what
the window produced against the plain reference under ``benchmark/reference/``.
With ``--trace 0`` the result carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics (``benchmark/metrics/<name>.py`` each), the
traced window's busy and wall seconds and the breakdown.

It exits non-zero, and prints no result, without a CUDA card or with fewer
cards than the cell asks for, and when JAX, flax or the JAX package
(``richsem_tpu``) is loaded in the process once the window has closed. Kernel
and compiler caches stay under ``build/`` in the checkout.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for var, sub in (("CUDA_CACHE_PATH", "cuda_cache"), ("TRITON_CACHE_DIR", "triton_cache"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = os.path.join(ROOT, "build", "benchmark", sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark.harness import core

    bench = core.load_json("BENCHMARK.json")
    try:
        cell, conf, mix = core.resolve(bench, args.workload)
    except KeyError:
        names = sorted(w["name"] for w in bench["workloads"])
        print(f"benchmark: no workload {args.workload!r}; the cells are {names}", file=sys.stderr)
        return 2

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    run = core.Run(bench, cell, conf, mix, args.seed, args.seconds, bool(args.trace))
    runner = importlib.import_module(f"benchmark.harness.{mix['kind']}_cell")
    out = runner.run(run, T_START)

    print("setup: " + ", ".join(f"{k} {v:.2f} s" for k, v in out["setup_parts"].items()),
          file=sys.stderr)
    bad = core.forbidden_modules()
    if bad:
        print(f"benchmark: the process loaded {bad} (JAX, flax or the JAX package)",
              file=sys.stderr)
        return 3
    dev = torch.device("cuda")
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
              "count": cell["chips"], "memory_peak_bytes": int(run.peak_bytes)}
    breakdown = None
    if args.trace:
        metrics = out["per_layer"]
        prof = out["window_profile"]
        if prof is None:
            print("benchmark: the traced window recorded no device time", file=sys.stderr)
            return 4
        device.update(busy_s=prof.busy_ms / 1e3, window_s=prof.wall_ms / 1e3)
        breakdown = prof.breakdown()
    else:
        names = [m["name"] for m in core.cell_metrics(bench, cell["name"], "end_to_end")]
        values = dict(out["e2e"], setup_s=out["setup_s"])
        units = {m["name"]: m["unit"] for m in bench["end_to_end"]}
        metrics = {n: {"value": float(values[n]), "unit": units[n]} for n in names}
    core.emit(out["correct"], out["attempted"], out["failed"], metrics, device, out["checks"],
              breakdown)
    return 0


if __name__ == "__main__":
    sys.exit(main())
