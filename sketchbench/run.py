"""Run one cell of the benchmark on the card this process starts on.

    python3 sketchbench/run.py --workload comfs.ingest --seed 7 \\
        --seconds 30 --trace 0

Prints the run's result as the last line of standard output, one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and ``checks`` last: each number the
check compared, beside its limit); the same numbers are the last lines of
standard error. With ``--trace 0`` the metrics are the cell's end-to-end
ones, with ``--trace 1`` its per-layer ones. Exits non-zero, printing no
result, without enough CUDA devices for the cell, when the package under
test is absent, or when a JAX module, or the JAX package ``repro``, is
loaded once the window has closed. The kernels build into the checkout's
``build/`` on the first run there.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# whole top-level module names that must not be loaded: the port's name
# begins with the reference package's, so a prefix test would be wrong
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def settle_malloc() -> None:
    """Put glibc's malloc where a long-running process ends up, by its own
    rule. Each time a process frees a block that malloc had mapped on its
    own, glibc raises its mapping threshold to that block's size (up to
    32 MiB, its ceiling on 64-bit hosts) and its trim threshold to twice
    that. A fresh process's thresholds therefore depend on which blocks its
    set-up happened to free, and runs read up to a third apart
    (``PERF.md``, section 2); a server that has run a while has freed
    blocks of every size its batches take and sits at the ceiling. Freeing
    one block just under 32 MiB puts this process there at once. No
    threshold is set: the allocator keeps its default rules."""
    import ctypes
    import ctypes.util
    try:
        libc = ctypes.CDLL(ctypes.util.find_library("c") or "libc.so.6")
        libc.malloc.restype = ctypes.c_void_p
        libc.malloc.argtypes = [ctypes.c_size_t]
        libc.free.argtypes = [ctypes.c_void_p]
        libc.free(libc.malloc((32 << 20) - 8192))
    except (OSError, AttributeError):  # not glibc: nothing to settle
        print("malloc left as it is", file=sys.stderr)


def forbidden_modules(modules=None) -> list:
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    settle_malloc()  # before any large allocation
    # the script's own folder is not a package root: its modules would
    # shadow the standard library's (``trace``)
    sys.path[:] = [p for p in sys.path
                   if Path(p or ".").resolve() != ROOT / "sketchbench"]
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))

    import torch

    from sketchbench import harness
    from sketchbench.catalog import Catalog

    cat = Catalog(ROOT)
    chips = int(cat.workload(args.workload)["chips"])
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); found {found}",
              file=sys.stderr)
        return 2
    out = harness.run_cell(cat, args.workload, args.seed, args.seconds,
                           bool(args.trace), "cuda", T_START)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in the run's process: {bad}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    for k, v in out["checks"].items():
        print(f"check {k}: {v['value']} (limit {v['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
