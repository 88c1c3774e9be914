"""A quick check of every flash-attention kernel instance, on the card.

    python3 tools/flash_instances.py

Builds the kernels from ``src/repro_torch/csrc`` (forced), prints the
flash source's ``-Xptxas -v`` lines (registers and spills of each head
dim and type), holds the kernel against its plain version at small and
ragged shapes of every head dim (16, 32, 64, 96, 128, 256), causal and
not, in f32 (|d| < 2e-5) and bf16 (|d| <= 2**-7 max(|plain|, 1)), then
times the prefill launches of Gemma-3 4B (dh=256, f32 and bf16),
phi-3-vision (dh=96) and Qwen3-8B (dh=128) by CUDA events (median of 5
after one warm launch). Exits 1 if any case disagrees. A first call after
a change to ``csrc/flash_attention.cu``: shorter than ``chip_smoke.py``.
Needs one card and nvcc.
"""
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    flash_attention_kernel, flash_attention_plain)

# (B, Hq, Hkv, L, dh): tile edges (1, 15, 65, 129, 130), ragged lengths
CASES = [(1, 4, 2, 1, 256), (2, 4, 2, 15, 256), (1, 8, 2, 65, 256),
         (2, 4, 1, 129, 256), (1, 8, 4, 1000, 256), (2, 4, 4, 130, 96),
         (1, 8, 8, 65, 96), (1, 4, 2, 1, 96), (1, 32, 8, 1000, 96),
         (2, 4, 2, 129, 16), (1, 8, 2, 300, 128), (2, 4, 2, 77, 64),
         (1, 6, 2, 130, 32)]
# (B, Hq, Hkv, L, dh, dtype): the prefill launches timed
TIMED = [(1, 8, 4, 8192, 256, torch.float32),
         (1, 32, 32, 2624, 96, torch.float32),
         (1, 8, 4, 8192, 256, torch.bfloat16),
         (1, 32, 8, 8192, 128, torch.float32)]


def close(got, want):
    d = (got.float() - want.float()).abs()
    if got.dtype == torch.bfloat16:
        return float(d.max()), bool(
            (d <= 2.0 ** -7 * want.float().abs().clamp_min(1)).all())
    return float(d.max()), float(d.max()) < 2e-5


def inputs(B, Hq, Hkv, L, dh, dt):
    g = torch.Generator(device="cuda").manual_seed(L + dh)
    return [torch.randn(s, generator=g, device="cuda").to(dt)
            for s in ((B, Hq, L, dh), (B, Hkv, L, dh), (B, Hkv, L, dh))]


def event_ms(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        ts.append(a.elapsed_time(b))
    return float(np.median(ts))


def main() -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    t0 = time.time()
    build.build(force=True)
    print("build", time.time() - t0)
    for line in build.PTXAS_LOG["flash_attention.cu"].splitlines():
        if "flash" in line or "registers" in line or "spill" in line:
            print(line)
    bad = 0
    for dt in (torch.float32, torch.bfloat16):
        for B, Hq, Hkv, L, dh in CASES:
            for causal in (True, False):
                q, k, v = inputs(B, Hq, Hkv, L, dh, dt)
                got = flash_attention_kernel(q, k, v, causal)
                want = flash_attention_plain(q, k, v, causal)
                torch.cuda.synchronize()
                err, ok = close(got, want)
                bad += not ok
                print(dt, (B, Hq, Hkv, L, dh), causal, err, ok, flush=True)
    for B, Hq, Hkv, L, dh, dt in TIMED:
        q, k, v = inputs(B, Hq, Hkv, L, dh, dt)
        err, ok = close(flash_attention_kernel(q, k, v, True),
                        flash_attention_plain(q, k, v, True))
        bad += not ok
        ms = event_ms(lambda: flash_attention_kernel(q, k, v, True))
        flops = 4 * dh * B * Hq * L * (L + 1) / 2
        print("TIME", dt, (B, Hq, Hkv, L, dh), "err", err, ok, "ms", ms,
              "TFLOP/s", flops / ms / 1e9, flush=True)
    print("BAD", bad)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
