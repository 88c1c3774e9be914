"""Perf-iteration harness (counterpart of ``repro.launch.perf_iter``):
estimate one cell with config overrides and print its roofline.

    python -m repro_torch.launch.perf_iter --arch deepseek-v2-236b \\
        --shape train_4k --set attn_mat_dtype=bf16 --tag it4
    python -m repro_torch.launch.perf_iter --arch deepseek-v2-236b \\
        --shape decode_32k --serving-shardings --tag it1 --top

``--top`` prints the largest contributors of the estimate (the napkin-math
input for the next hypothesis): the port's functions ranked by FLOPs,
bytes accessed, saved activation bytes and collective bytes, each a
backward's cost under the forward function that made it (the reference
ranks HLO instructions).
"""

from __future__ import annotations

import argparse
import json

import torch

from repro_torch.launch import dryrun

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
TOP_KEYS = ("flops", "bytes_accessed", "activation_bytes",
            "collective_bytes")


def parse_overrides(pairs):
    out = {}
    for p in pairs or []:
        k, v = p.split("=", 1)
        if v in DTYPES:
            out[k] = DTYPES[v]
        elif v in ("True", "False"):
            out[k] = v == "True"
        elif v.replace(".", "").replace("-", "").isdigit():
            out[k] = float(v) if "." in v else int(v)
        else:
            out[k] = v
    return out


def top_contributors(rec: dict, n: int = 10) -> dict:
    """``{cost: [(source, amount), ...]}``: the ``n`` largest sources of
    each cost of an estimate record, per device."""
    out = {}
    for key in TOP_KEYS:
        rows = [(src, v[key]) for src, v in rec["sources"].items()
                if v.get(key)]
        out[key] = sorted(rows, key=lambda kv: -kv[1])[:n]
    return out


def print_top(rec: dict, n: int = 10) -> None:
    for key, rows in top_contributors(rec, n).items():
        total = sum(v.get(key, 0) for v in rec["sources"].values())
        print(f"\n== top {key.replace('_', ' ')} (per device) ==")
        for src, v in rows:
            print(f"{v:14.4g} {v / max(total, 1):7.2%}  {src}")


def serving_shardings():
    """Parameters replicated over data (pure TP): ``mesh_axes``' fsdp
    emptied where the estimator reads it, as the reference rewires its
    own."""
    import repro_torch.launch.mesh as mesh_mod
    from repro_torch.launch import step_fns

    orig = mesh_mod.mesh_axes

    def serving_axes(mesh):
        return dict(orig(mesh), fsdp=())

    for mod in (mesh_mod, step_fns, dryrun):
        mod.mesh_axes = serving_axes


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--set", nargs="*", default=[],
                    help="ModelConfig overrides k=v")
    ap.add_argument("--serving-shardings", action="store_true",
                    help="replicate params over data (pure TP) — decode")
    ap.add_argument("--tag", default="iter")
    ap.add_argument("--top", action="store_true",
                    help="print the top contributors of the estimate")
    args = ap.parse_args(argv)

    overrides = parse_overrides(args.set)
    if args.serving_shardings:
        serving_shardings()
    rec = dryrun.lower_cell(args.arch, args.shape, args.multipod, overrides)
    if args.top:
        print_top(rec)
    rl = rec["roofline"]
    print(f"\n[{args.tag}] {args.arch} x {args.shape}: "
          f"compute={rl['compute_s']:.4f}s memory={rl['memory_s']:.4f}s "
          f"collective={rl['collective_s']:.4f}s dom={rl['dominant']} "
          f"useful={rl['useful_flops_ratio']:.3f} "
          f"peak={rec['memory']['peak_bytes'] / 1e9:.2f}GB")
    out = dryrun.OUT_DIR / (f"{args.arch}__{args.shape}__"
                            f"{'2x16x16' if args.multipod else '16x16'}"
                            f"__{args.tag}.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rec, indent=1))
    print("wrote", out)


if __name__ == "__main__":
    main()
