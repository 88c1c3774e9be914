"""The flash backward's card numbers alone, on one card.

    python3 tools/flash_backward_times.py [--train] [--out NAME]

Runs ``chip_smoke.py``'s own functions for the flash kernels: the phase-2
build report (each forward and backward instance's registers, spills and
HMMA count), L1 (the forward against its plain version and SDPA), L7 (the
backward pair against ``flash_attention_backward_plain`` and SDPA's
backward on every ``FLASH_BWD_CASES`` case, two launches bit-identical)
and, with ``--train``, L8 (SmolLM-135M trained at full width, its
profiled step split by kernel group). It takes the ``repro_torch`` found
first on ``PYTHONPATH``, or this checkout's, so an A/B of two trees runs
it once per tree in one card call (parent, change, change, parent) with
``PYTHONPATH=<tree>/src``. Writes ``chiprun_out/NAME.json`` (default
``flash_backward_times``). About 1.5 minutes of card time, 3 with
``--train``; needs nvcc.
"""
import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.append(str(ROOT / "src"))  # after PYTHONPATH's trees
import repro_torch.kernels.build as build  # noqa: E402

sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402  (repro_torch is already imported)
from repro_torch import configs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--train", action="store_true")
    ap.add_argument("--out", default="flash_backward_times")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = cs.card_line()
    tag = f"[{card}]"
    print(f"{card}; kernels from {Path(build.__file__).parents[1]}",
          flush=True)
    t0 = time.perf_counter()
    build.build(force=True)
    build.load_library()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    fwd, bwd = cs.flash_build_report()
    out = {"card": card, "build_forward": fwd, "build_backward": bwd}
    with torch.no_grad():
        out.update(cs.check_flash_kernel(dev, tag))  # L1
    out.update(cs.check_flash_backward(  # L7
        dev, tag, out["flash_attention_kernel"]["ms"]))
    if args.train:  # L8
        train = cs.train_phase(dev, tag)
        cs.check_train_on_the_card(
            configs.get(cs.TRAIN_ARCH, reduced=cs.LM_REDUCED), train)
        out["train"] = {k: v for k, v in train.items() if k != "losses"}
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / f"{args.out}.json").write_text(
        json.dumps(out, indent=1, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
