"""Readings for the check's limits, on the card at a cell's own size: the
program's sound runs and the control's, several seeds in one process.

    python3 sketchbench/control.py --workload comfs.ingest \\
        --seeds 11,12,13 --seconds 5 [--control]

Each seed runs the cell as ``run.py`` does (set-up, a window of
``--seconds``, the check); with ``--control`` the check's rounds answer
from the state before the round's batches (``check.CONTROL``), which the
limits must refuse. Prints one JSON line a seed: the seed, ``correct`` and
every number compared. The benchmark's own runs never run the control.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    sys.path[:] = [p for p in sys.path
                   if Path(p or ".").resolve() != ROOT / "sketchbench"]
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    from sketchbench.run import settle_malloc
    settle_malloc()
    import torch

    from sketchbench import check, harness
    from sketchbench.catalog import Catalog

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cat = Catalog(ROOT)
    t = T_START
    for seed in (int(s) for s in args.seeds.split(",")):
        out = harness.run_cell(cat, args.workload, seed, args.seconds, False,
                               "cuda", t,
                               control=check.CONTROL if args.control
                               else None)
        print(json.dumps({"seed": seed, "control": args.control,
                          "correct": out["correct"],
                          "checks": out["checks"],
                          "metrics": out["metrics"]}), flush=True)
        torch.cuda.empty_cache()
        t = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
