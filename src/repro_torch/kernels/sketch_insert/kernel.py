"""Block-binned first-fit insert: CUDA kernel wrapper and plain version.

``sketch_insert_kernel_sharded`` replaces the TPU kernel
``repro/kernels/sketch_insert/kernel.py::sketch_insert_kernel_sharded``
(source: ``csrc/sketch_insert.cu``, one warp per (shard, bin); what bounds
it is noted there). ``sketch_insert_plain`` is its vectorized PyTorch twin
(the counterpart of ``sketch_insert_stream_walk``): one step walks edge
``t`` of every bin at once. The wrapper takes the plain version only for
CPU tensors; for CUDA tensors it launches the kernel or raises.

Contract (both versions, in place on ``key``/``C``/``P``):
  rows/cols/keys [S, B, s] absolute probe coordinates in stream order;
  w/le [S, B]; slot [S] each shard's ring slot; order [S, B] the stable
  bin sort; offs/counts [S, n^2] bin start and fill in the sorted stream;
  key [S, d, d, 2], C [S, d, d, 2, k], P [S, d, d, 2, k, c].
  Bin ``(sh, nb)`` walks its first ``min(counts, max_bin)`` edges.
  Returns ``inserted`` bool [S, B] in stream order.
"""

from __future__ import annotations

import torch

from repro_torch.core.types import EMPTY
from repro_torch.kernels import build


def sketch_insert_plain(rows, cols, keys, w, le, slot, order, offs, counts,
                        key, C, P, max_bin: int):
    S, B, s = rows.shape
    nb2 = counts.shape[1]
    NB = S * nb2
    dev = rows.device
    cnt = counts.reshape(NB).clamp(max=max_bin)
    limit = int(cnt.max()) if NB else 0
    shard = torch.arange(NB, device=dev) // nb2
    base = shard * B + offs.reshape(NB)
    order_g = (order.long() + torch.arange(S, device=dev)[:, None] * B
               ).reshape(S * B)  # sorted position -> global stream index
    rows_f, cols_f, keys_f = (x.reshape(S * B, s) for x in (rows, cols, keys))
    w_f, le_f = w.reshape(S * B), le.reshape(S * B)
    tz2 = torch.arange(2, device=dev)
    inserted = torch.zeros(S * B, dtype=torch.bool, device=dev)
    for t in range(limit):
        live = t < cnt
        gi = order_g[(base + t).clamp(max=S * B - 1)]
        r, cc, kk = rows_f[gi].long(), cols_f[gi].long(), keys_f[gi]
        cur = key[shard[:, None, None], r[:, :, None], cc[:, :, None],
                  tz2[None, None, :]]  # [NB, s, 2], probe-major
        ok = ((cur == kk[:, :, None]) | (cur == EMPTY)).reshape(NB, 2 * s)
        w_t = w_f[gi]
        found = ok.any(1) & (w_t > 0) & live
        first = torch.argmax(ok.to(torch.uint8), dim=1)
        pi, tz = first // 2, first % 2
        sel = torch.nonzero(found).flatten()
        if sel.numel() == 0:
            continue
        sh, pis, tzs, g = shard[sel], pi[sel], tz[sel], gi[sel]
        rs = r[sel, pis]
        cs = cc[sel, pis]
        ws = w_t[sel]
        key[sh, rs, cs, tzs] = kk[sel, pis]
        sl = slot.long()[sh]
        C[sh, rs, cs, tzs, sl] += ws  # bins own disjoint cells: no repeats
        P[sh, rs, cs, tzs, sl, le_f[g].long()] += ws
        inserted[g] = True
    return inserted.reshape(S, B)


def sketch_insert_kernel_sharded(rows, cols, keys, w, le, slot, order, offs,
                                 counts, key, C, P, max_bin: int):
    if key.device.type == "cpu":
        return sketch_insert_plain(rows, cols, keys, w, le, slot, order,
                                   offs, counts, key, C, P, max_bin)
    build.check_cuda(rows, cols, keys, w, le, slot, order, offs, counts,
                     key, C, P)
    S, B, s = rows.shape
    d, k, c = key.shape[1], C.shape[-1], P.shape[-1]
    inserted = torch.zeros((S, B), dtype=torch.int32, device=key.device)
    build.call("lsk_sketch_insert", rows, cols, keys, w, le, slot, order,
               offs, counts, key, C, P, inserted, S, B, s, d,
               counts.shape[1], k, c, max_bin)
    sketch_insert_kernel_sharded.launches += 1
    return inserted.bool()


sketch_insert_kernel_sharded.launches = 0
