"""How far f32 arithmetic alone moves the random-weight models that
``chip_smoke.py``'s L13 serves, and L13's parts at published depth.

    python3 tools/serve_tp_conditioning.py --cpu [--tokens 512]
    python3 tools/serve_tp_conditioning.py --card

``--cpu`` (the CPU, ~3 minutes): xLSTM-1.3B at its published widths cut
to one period of its 7:1 pattern (8 layers, L13b's model), seeded as L13
seeds it: the largest change of the logits of a 512-token prefill when
one weight moves by 2 ulps, and each gradient leaf of the one-device f32
step (2 x ``--tokens`` tokens, L13b's batch at 512) against the same
step in f64 (max |f32 - f64| over the leaf's largest |f64|; the model
code keeps some sums f32, so the f64 side is an upper bound on f32's
own error).

``--card`` (one card, ~6 minutes): L13's parts b and c at published
depth (xLSTM-1.3B's 48 layers, Gemma-3 4B's 34), their bounds lifted:
prints how far the split lands from one device there, and the ms a step.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch.step_fns import _grads  # noqa: E402
from repro_torch.models import lm  # noqa: E402


def cpu(tokens: int) -> dict:
    torch.set_num_threads(6)
    base = configs.get("xlstm_13b").replace(n_layers=8)
    rng = np.random.default_rng(cs.SEED + 14)
    prompt = torch.from_numpy(rng.integers(0, base.vocab_size, (1, 512),
                                           dtype=np.int32))
    params = lm.init_params(base, torch.Generator().manual_seed(cs.SEED),
                            "cpu")
    with torch.no_grad():
        a, _ = lm.forward(base, params, {"tokens": prompt})
        params.layers[0].mixer.w_in.mul_(1 + 2 ** -22)
        b, _ = lm.forward(base, params, {"tokens": prompt})
    ulp = float((a - b).abs().max() / a.abs().max())
    del params, a, b
    toks = rng.integers(0, base.vocab_size, (2, tokens + 1), dtype=np.int32)
    batch = {"tokens": torch.from_numpy(toks[:, :-1].copy()),
             "labels": torch.from_numpy(toks[:, 1:].copy())}
    grads = {}
    for dtype in (torch.float32, torch.float64):
        cfg = base.replace(param_dtype=dtype, compute_dtype=dtype)
        p = lm.init_params(cfg, torch.Generator().manual_seed(cs.SEED),
                           "cpu").requires_grad_(True)
        _, _, g = _grads(cfg, p, batch)
        grads[dtype] = {k: v.detach().double() for k, v in g.items()}
        del p, g
    g32, g64 = grads[torch.float32], grads[torch.float64]
    errs = {k: float((g32[k] - g64[k]).abs().max() / g64[k].abs().max())
            for k in g64}
    top = dict(sorted(errs.items(), key=lambda kv: -kv[1])[:5])
    return dict(model=f"{base.name}, 8 layers", two_ulp_logit_rel=ulp,
                tokens=f"2 x {tokens}", f32_vs_f64_leaf_rel=top)


def card() -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.build.build(force=True)
    cs.build.load_library()
    cs.LOGIT_TOL, cs.SERVE_TP_GRAD_REL = 1.0, 1.0
    tag = f"[{cs.card_line()}]"
    parts = {"b": dict(cs.SERVE_TP_PARTS["b"], reduced=False),
             "c": dict(cs.SERVE_TP_PARTS["c"], reduced=False,
                       seq=cs.CP_SEQ_MAX)}
    for run in parts.values():
        run.pop("layers")
    out = cs.serve_tp_phase(torch.device("cuda"), tag, parts)
    return {p: {k: out[p][k] for k in ("prefill", "decode", "train", "cp")
                if k in out[p]} for p in parts}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--card", action="store_true")
    ap.add_argument("--tokens", type=int, default=512)
    args = ap.parse_args(argv)
    t0 = time.time()
    out = cpu(args.tokens) if args.cpu else card() if args.card else \
        ap.error("--cpu or --card")
    print(json.dumps(dict(out, seconds=time.time() - t0), default=str))


if __name__ == "__main__":
    main()
