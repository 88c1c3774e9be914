"""Where a pool-kernel round's cycles go, on the card.

    python3 tools/pool_round_costs.py

Builds clock-instrumented copies of ``src/repro_torch/csrc/pool_pass.cu``
(into ``build/pool_round_costs``, one nvcc each, in parallel), runs the
deployment of ``chip_smoke.py`` through ingest, captures the pool pass of
the last kernel-route flush and walks it with each copy, twice. Each copy
reports, per shard, the rounds and the clock64 cycles its walk spent
waiting for a group's records and in the group's rounds (written over the
stats buffer's voided_same_pair / merged_same_pair columns). The copies
without __match_any_sync or without the probe loads give wrong pools;
they only time what is left. Needs one card and nvcc.
"""
import contextlib
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from repro_torch import sketch as skt  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.sketch_insert.kernel import (  # noqa: E402
    pool_pass_plain, pool_stats_buffer, pool_stats_split)


def patch(src, pairs):
    for a, b in pairs:
        if a not in src:
            raise ValueError(f"pool_pass.cu no longer holds {a!r}")
        src = src.replace(a, b)
    return src


CLOCKS = [
    ("    for (int g0 = 0, buf = 0; g0 < n; g0 += LSK_POOL_GROUP) {\n",
     "    long long t_wait = 0, t_round = 0;\n"
     "    for (int g0 = 0, buf = 0; g0 < n; g0 += LSK_POOL_GROUP) {\n"
     "      long long c0 = clock64();\n"),
    ("      __syncwarp();\n      const int m = min(LSK_POOL_GROUP, n - g0);",
     "      __syncwarp();\n      long long c1 = clock64(); t_wait += c1 - c0;"
     "\n      const int m = min(LSK_POOL_GROUP, n - g0);"),
    ("      if (cslot >= 0) {  // the group's adds",
     "      t_round += clock64() - c1;\n"
     "      if (cslot >= 0) {  // the group's adds"),
    ("      st[LSK_ST_MERGED] = n_merged;",
     "      st[LSK_ST_MERGED] = t_round;\n"
     "      st[LSK_ST_VOID_SAME] = t_wait;")]
NO_MATCH = [("""        const unsigned same = __match_any_sync(0xffffffffu,
                                               claim ? wslot : -2 - lane);""",
             "        const unsigned same = 1u << lane;")]
NO_PROBES = [("        if (act) {\n          // the probe slots",
              "        if (act) { wslot = base; claim = wk > 0; }\n"
              "        if (false) {\n          // the probe slots")]


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    src = (ROOT / "src/repro_torch/csrc/pool_pass.cu").read_text()
    copies = {"kernel": CLOCKS, "no_match_any": CLOCKS + NO_MATCH,
              "no_probes": CLOCKS + NO_PROBES,
              "no_match_no_probes": CLOCKS + NO_MATCH + NO_PROBES}
    out = ROOT / "build" / "pool_round_costs"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, pairs in copies.items():
        f = out / f"{name}.cu"
        f.write_text(patch(src, pairs))
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
             "-Xcompiler", "-fPIC", "-I", str(build.CSRC), str(f), "-o",
             str(out / f"{name}.so")])
    libs = {}
    for name, p in procs.items():
        if p.wait() != 0:
            raise RuntimeError(f"nvcc failed on {name}")
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        lib.lsk_pool_pass.argtypes = build.SIGNATURES["lsk_pool_pass"]
        libs[name] = lib
    print(cs.card_line(), flush=True)
    spec, stream, flushes, span_i = cs.deployment()
    state = skt.create(spec, device="cuda")
    capture = cs.PoolCapture()
    last_k = max(i for i in range(len(flushes)) if i != span_i)
    for i, (a, z) in enumerate(flushes):
        with capture if i == last_k else contextlib.nullcontext():
            state = skt.ingest(spec, state, stream.slice(a, z), path="cuda")
    items, leaves, kw = capture.items, capture.leaves, capture.kw
    del state
    S, B = items[0].shape
    Q, k, c = leaves[0].shape[1], leaves[1].shape[-1], leaves[2].shape[-1]
    want = [x.clone() for x in leaves]
    pool_pass_plain(*items, *want, **kw)
    seed32 = ((kw["seed"] & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000
    for rep in range(2):
        for name, lib in libs.items():
            got = [x.clone() for x in leaves]
            st = pool_stats_buffer(S, "cuda")
            scratch = torch.empty(S * B * 8 + S * -(-B // 1024),
                                  dtype=torch.int32, device="cuda")
            args = [a.data_ptr() if isinstance(a, torch.Tensor) else a
                    for a in (*items, *got, scratch, st, S, B, kw["probes"],
                              Q, k, c, seed32)]
            rc = lib.lsk_pool_pass(*args,
                                   torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"{name}: CUDA error {rc}")
            torch.cuda.synchronize()
            equal = all(torch.equal(a, b) for a, b in zip(got, want))
            sp = pool_stats_split(st.cpu())
            print(f"run {rep} {name}: pool equal to plain {equal}; rounds "
                  f"{sp['rounds']}, walk ns {sp['walk_ns']}, cycles waiting "
                  f"for records {sp['voided_same_pair']}, cycles in rounds "
                  f"{sp['merged_same_pair']}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
