"""The flash kernels' outputs on fixed inputs, saved, and two saves compared
bit for bit: whether a change to ``csrc/flash_attention.cu`` or
``csrc/flash_attention_bwd.cu`` leaves every launch without a query offset
as it was.

Each case draws q, k, v and dout from one seeded generator on the card and
saves the forward's out and lse and the backward pair's dq, dk and dv, at
L1's and L7's shapes (f32 and bf16, every head dim the models use). Run it
once per tree, with that tree's ``src`` on ``PYTHONPATH`` (each tree builds
its own kernels), then compare:

  PYTHONPATH=<parent>/src python3 tools/flash_offset_identity.py --save a.pt
  PYTHONPATH=src python3 tools/flash_offset_identity.py --save b.pt
  python3 tools/flash_offset_identity.py --compare a.pt b.pt

``--compare`` prints one JSON line (the cases, the tensors that differ)
and exits 1 if any does.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

# (B, Hq, Hkv, L, dh, dtype): L1's Qwen3-8B and SmolLM-135M shapes, L7's
# training shapes, Gemma-3's dh 256, phi-3-vision's dh 96, a ragged length
CASES = [
    (1, 32, 8, 8192, 128, torch.float32),
    (4, 9, 3, 2048, 64, torch.float32),
    (2, 32, 8, 2048, 128, torch.bfloat16),
    (4, 9, 3, 4096, 64, torch.float32),
    (1, 8, 4, 2048, 256, torch.float32),
    (1, 8, 4, 2048, 256, torch.bfloat16),
    (1, 32, 32, 1000, 96, torch.float32),
    (2, 4, 1, 129, 16, torch.float32),
    (2, 8, 2, 1000, 128, torch.bfloat16),
]


def run_cases() -> dict:
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_backward_kernel, flash_attention_kernel)

    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for B, Hq, Hkv, L, dh, dt in CASES:
        g = torch.Generator(device="cuda").manual_seed(L * dh + Hq)
        q, k, v, do = [torch.randn(s, generator=g, device="cuda").to(dt)
                       for s in ((B, Hq, L, dh), (B, Hkv, L, dh),
                                 (B, Hkv, L, dh), (B, Hq, L, dh))]
        o, lse = flash_attention_kernel(q, k, v, True, lse=True)
        dq, dk, dv = flash_attention_backward_kernel(q, k, v, o, lse, do, True)
        key = f"{B}x{Hq}x{Hkv}x{L}x{dh}-{str(dt)[6:]}"
        out[key] = {n: t.cpu() for n, t in
                    (("out", o), ("lse", lse), ("dq", dq), ("dk", dk),
                     ("dv", dv))}
    torch.cuda.synchronize()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--save", metavar="PATH")
    ap.add_argument("--compare", nargs=2, metavar=("A", "B"))
    args = ap.parse_args(argv)
    if args.save:
        torch.save(run_cases(), args.save)
        print(f"saved {len(CASES)} cases to {args.save}")
        return 0
    if args.compare:
        a, b = (torch.load(p) for p in args.compare)
        differ = [f"{c}.{n}" for c in a for n in a[c]
                  if c not in b or not torch.equal(a[c][n], b[c][n])]
        print(json.dumps({"cases": len(a), "tensors": sum(map(len,
                                                              a.values())),
                          "differ": differ}))
        return 1 if differ or set(a) != set(b) else 0
    ap.error("give --save or --compare")
    return 2


if __name__ == "__main__":
    sys.exit(main())
