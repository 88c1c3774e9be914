"""Where an edge query's time goes, on the card.

    python3 tools/edge_query_split.py

Runs the deployment of ``chip_smoke.py`` through ingest on one card (the
tree's own ``chip_smoke`` and ``src``), then splits one 1,024-query edge
batch with the edge label, on the cached planes, by CUDA events (median of
``REPS``): the host addressing (``precompute`` x2, ``edge_probes``,
``edge_label_bucket``, ``pool_slot_seq``), the walk kernel
(``sketch_query_kernel_sharded``), the vectorized pool lookup, the fused
entry (``edge_query_kernel``, where the tree has one) and the whole
``skt.query(..., path="cuda")``; the walk kernel's and the fused entry's
profiler device time beside their event windows; the ``cudaLaunchKernel``
and ``cudaMemcpyAsync`` calls of one edge ``skt.query``; and phase 5's
edge batches (host clock) and one list-``last`` edge sweep. The fused
entry aside, which it times only where the tree has one, it uses what
the walk kernel's contract entry and ``chip_smoke.py`` offered before
the fused entry came, so it runs on such an older tree too: copy it into
that tree's ``tools/``. Prints one JSON line last. Needs one card and
nvcc.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
REPS = 5
WINDOW = 50  # launches in an event window


def _sync():
    torch.cuda.synchronize()


def _spans(stages, reps):
    """Medians over ``reps`` runs of the CUDA-event time of each stage of
    ``stages`` (callables run in order, each fed the previous one's
    result)."""
    runs = []
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True)
              for _ in range(len(stages) + 1)]
        _sync()
        ev[0].record()
        x = None
        for e, fn in zip(ev[1:], stages):
            x = fn(x)
            e.record()
        _sync()
        runs.append([a.elapsed_time(b) for a, b in zip(ev, ev[1:])])
    return [float(np.median(t)) for t in zip(*runs)]


def api_calls(fn) -> dict:
    """CUDA runtime calls of one ``fn()`` by name, from a profiler trace."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    _sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        _sync()
    return {e.key: e.count for e in prof.key_averages()
            if e.key.startswith(("cudaLaunchKernel", "cudaMemcpy"))}


def edge_query_split(cs, cfg, spec, state, qi, dev, tag) -> dict:
    """One 1,024-query edge batch with the edge label on ``state``'s
    cached planes, split by stage (``cs`` is the tree's ``chip_smoke``).
    Returns the numbers, and logs them."""
    from repro_torch import sketch as skt
    from repro_torch.core import hashing as hsh
    from repro_torch.core.lsketch import edge_probes, precompute
    from repro_torch.kernels.sketch_query import kernel as qk

    planes = skt.query_planes(spec, state, None)
    t = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
    src, la, dst, lb, le = (t(qi[k]) for k in ("src", "src_label", "dst",
                                               "dst_label", "le"))
    S = planes.key.shape[0]
    s_idx = torch.arange(S, device=dev)[:, None]

    def addressing(_):
        pr = edge_probes(cfg, precompute(cfg, src, la),
                         precompute(cfg, dst, lb))
        le_idx = hsh.edge_label_bucket(le, cfg.c, cfg.seed)
        ps = hsh.pool_slot_seq(pr.pid_src, pr.pid_dst, cfg.pool_capacity,
                               cfg.pool_probes, cfg.seed).long()
        return pr, le_idx, ps

    def walk(x):
        pr, le_idx, ps = x
        return x, qk.sketch_query_kernel_sharded(
            pr.rows.contiguous(), pr.cols.contiguous(), pr.keys.contiguous(),
            le_idx, planes.key, planes.cw, planes.pw)

    def pool(x):  # the walk kernel's caller's pool lookup
        (pr, le_idx, ps), (w, wl, go_pool) = x
        pk = planes.pool_key[:, ps]
        pmatch = (pk[..., 0] == pr.pid_src[None, :, None]) & \
            (pk[..., 1] == pr.pid_dst[None, :, None])
        pfirst = torch.argmax(pmatch.to(torch.uint8), dim=-1)
        pslot = torch.gather(ps.expand((S,) + ps.shape), -1,
                             pfirst[..., None])[..., 0]
        sel = go_pool.bool() & pmatch.any(-1)
        w = w + torch.where(sel, planes.pool_cw[s_idx, pslot], 0)
        wl_p = planes.pool_pw[s_idx, pslot, le_idx.long()[None, :]]
        return w, wl + torch.where(sel, wl_p, 0)

    q = cs.query_batch(qi, "edge", True, None)
    query = lambda _: skt.query(spec, state, q, path="cuda")  # noqa: E731
    addr_ms, walk_ms, pool_ms = _spans([addressing, walk, pool], REPS)
    (query_ms,) = _spans([query], REPS)
    x = walk(addressing(None))[0]
    pr, le_idx, _ = x
    w_args = (pr.rows.contiguous(), pr.cols.contiguous(),
              pr.keys.contiguous(), le_idx, planes.key, planes.cw, planes.pw)
    walk_window = cs.event_ms(
        lambda: qk.sketch_query_kernel_sharded(*w_args), WINDOW)
    walk_dev = cs.device_ms(
        lambda: qk.sketch_query_kernel_sharded(*w_args), 20)
    out = dict(addressing_ms=addr_ms, walk_ms=walk_ms, pool_lookup_ms=pool_ms,
               query_ms=query_ms, walk_window_ms=walk_window,
               walk_device_ms=walk_dev["total"],
               query_api_calls=api_calls(lambda: query(None)))
    fused = getattr(qk, "edge_query_kernel", None)
    if fused is not None:
        f_args = (cfg, planes, src, la, dst, lb, le)
        (out["fused_ms"],) = _spans([lambda _: fused(*f_args)], REPS)
        out["fused_window_ms"] = cs.event_ms(lambda: fused(*f_args), WINDOW)
        out["fused_device_ms"] = cs.device_ms(lambda: fused(*f_args),
                                              20)["total"]
    cs._log(f"edge query split (one batch of {len(qi['src'])}, with the edge "
            f"label, cached planes, CUDA events, median of {REPS}): "
            f"{json.dumps(out)} {tag}")
    return out


def edge_query_times(cs, spec, state, qi, tag) -> dict:
    """Phase 5's edge batches (with and without the label, at every
    horizon; host clock around a synchronised query) and one list-``last``
    sweep with the label: microseconds a query."""
    from repro_torch import sketch as skt

    times = []
    for with_le in (False, True):
        for last in cs.HORIZONS:
            q = cs.query_batch(qi, "edge", with_le, last)
            skt.query_planes(spec, state, last)  # plane build: set-up
            _, sec = cs._timed(lambda: skt.query(spec, state, q,
                                                 path="cuda"))
            times.append(sec)
    q = cs.query_batch(qi, "edge", True, list(cs.HORIZONS))
    skt.query_planes_multi(spec, state, list(cs.HORIZONS))
    _, sweep = cs._timed(lambda: skt.query(spec, state, q, path="cuda"))
    n = len(qi["src"])
    out = dict(edge_us_per_query=1e6 * float(np.mean(times)) / n,
               sweep_us_per_query=1e6 * sweep / n)
    cs._log(f"edge queries (host clock): {json.dumps(out)} {tag}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch import sketch as skt
    from repro_torch.kernels import build

    card = cs.card_line()
    tag = f"[{card}]"
    build.build(force=True)
    build.load_library()
    spec, stream, flushes, _ = cs.deployment()
    state = skt.create(spec, device="cuda")
    for a, z in flushes:
        state = skt.ingest(spec, state, stream.slice(a, z), path="cuda")
    qi = cs.query_inputs(cs.CFG, stream)
    dev = torch.device("cuda")
    edge_query_times(cs, spec, state, qi, tag)  # warm-up
    out = edge_query_split(cs, cs.CFG, spec, state, qi, dev, tag)
    out.update(edge_query_times(cs, spec, state, qi, tag))
    print(card, flush=True)
    print(json.dumps(dict(out, tree=str(ROOT), card=card)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
