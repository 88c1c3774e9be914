"""Edge probe walk on window-reduced planes: CUDA kernel wrapper and plain
version.

``sketch_query_kernel_sharded`` replaces the TPU kernel
``repro/kernels/sketch_query/kernel.py::sketch_query_kernel_sharded``
(source: ``csrc/sketch_query.cu``, one thread per (shard, query); what
bounds it is noted there). ``sketch_query_plain`` is the vectorized
PyTorch twin (counterpart of ``sketch_query_xla``). The wrapper takes the
plain version only for CPU tensors; for CUDA tensors it launches the
kernel or raises.

rows/cols/keys [nq, s]; le [nq] or None (no label plane); key_plane/cw
[S, 2, d, d]; pw [S, 2, d, d, c]. Returns (w, w_label, go_pool), each
[S, nq] (w_label is 0 without a label).
"""

from __future__ import annotations

import torch

from repro_torch.core.types import EMPTY
from repro_torch.kernels import build


def sketch_query_plain(rows, cols, keys, le, key_plane, cw, pw):
    S = key_plane.shape[0]
    nq, s = rows.shape
    r, c = rows.long(), cols.long()
    cur = key_plane[:, :, r, c].movedim(1, -1)  # [S, nq, s, 2]
    is_m = (cur == keys[None, :, :, None]).reshape(S, nq, 2 * s)
    is_e = (cur == EMPTY).reshape(S, nq, 2 * s)
    stop = is_m | is_e
    any_stop = stop.any(-1)
    first = torch.argmax(stop.to(torch.uint8), dim=-1)  # [S, nq]
    hit = torch.gather(is_m, -1, first[..., None])[..., 0] & any_stop
    pi, tz = first // 2, first % 2
    rr = torch.gather(r.expand(S, nq, s), -1, pi[..., None])[..., 0]
    cc = torch.gather(c.expand(S, nq, s), -1, pi[..., None])[..., 0]
    s_idx = torch.arange(S, device=rows.device)[:, None]
    w = torch.where(hit, cw[s_idx, tz, rr, cc], 0)
    if le is None:
        wl = torch.zeros_like(w)
    else:
        wl = torch.where(hit, pw[s_idx, tz, rr, cc, le.long()[None, :]], 0)
    return w, wl, ~any_stop


def sketch_query_kernel_sharded(rows, cols, keys, le, key_plane, cw, pw):
    if key_plane.device.type == "cpu":
        return sketch_query_plain(rows, cols, keys, le, key_plane, cw, pw)
    build.check_cuda(rows, cols, keys, le, key_plane, cw, pw)
    S, _, d, _ = key_plane.shape
    nq, s = rows.shape
    out = torch.empty((3, S, nq), dtype=torch.int32, device=key_plane.device)
    build.call("lsk_sketch_query", rows, cols, keys, le, key_plane, cw, pw,
               out[0], out[1], out[2], S, nq, s, d, pw.shape[-1])
    sketch_query_kernel_sharded.launches += 1
    return out[0], out[1], out[2].bool()


sketch_query_kernel_sharded.launches = 0
