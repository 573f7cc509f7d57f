"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout on a machine with the card(s) the cell
asks for.  It sets up (weights from the seed, build or load of the
kernels, warm-up), measures for ``--seconds``, checks what the timed path
produced against the plain reference, and prints the result as one JSON
object on the last line of standard output, after the numbers it compared
on standard error.  It exits non-zero, printing no result, without a card,
outside a checkout of the program, or when JAX or the JAX package was
loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: modules whose presence refuses the run, by whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules():
    return sorted({n.split(".")[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every cache of the program and of its libraries at a fixed path in
    # the checkout: the kernels' nvcc builds already go to build/repro_torch
    cache = ROOT / "build" / "perfbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("perfbench: the program (src/repro_torch) is not in this "
              "checkout", file=sys.stderr)
        return 3
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from perfbench.core import run as R
    from perfbench.core.driver import print_checks, run_cell
    bench = R.benchmark()
    wl = R.workload(bench, args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(wl["chips"]):
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: {args.workload} needs {wl['chips']} CUDA "
              f"device(s); found {found}", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    out = run_cell(bench, wl, seed=args.seed, seconds=args.seconds,
                   trace=bool(args.trace), device="cuda", t_start=T_START)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: the run loaded {bad}", file=sys.stderr)
        return 4
    print_checks(out["checks"])
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
