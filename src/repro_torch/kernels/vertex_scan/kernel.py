"""Vertex-aggregate line scan on window-reduced planes: CUDA kernel wrapper
and plain version.

``vertex_scan_kernel_sharded`` replaces the TPU kernel
``repro/kernels/vertex_scan/kernel.py::vertex_scan_kernel_sharded``
(source: ``csrc/vertex_scan.cu``, line-major: a counting sort groups the
nq x r references by line on the card, then one block per (line, shard)
for ``out`` and per (tile of 32 columns, shard) for ``in`` reads each
line once; what bounds it is noted there). ``vertex_scan_plain`` is the
vectorized PyTorch twin (counterpart of ``vertex_scan_xla``), with the ``in``
direction read natively by columns. The wrapper takes the plain version
only for CPU tensors; for CUDA tensors it launches the kernel or raises.

lines [nq, r] absolute candidate rows (out) or columns (in); f [nq];
le [nq] or None; key_plane/cw [S, 2, d, d]; pw [S, 2, d, d, c].
Returns (w, w_label), each [S, nq].
"""

from __future__ import annotations

import torch

from repro_torch.core import hashing as hsh
from repro_torch.core.types import EMPTY
from repro_torch.kernels import build


def _sum32(x, dim):
    return x.sum(dim=dim, dtype=torch.int64).to(torch.int32)


def vertex_scan_plain(lines, f, le, key_plane, cw, pw, *, r: int, F: int,
                      direction: str = "out"):
    S = key_plane.shape[0]
    nq = lines.shape[0]
    w = torch.zeros((S, nq), dtype=torch.int32, device=lines.device)
    wl = torch.zeros_like(w)
    for i in range(r):  # peak transient [S, 2, nq, d]
        li = lines[:, i].long()
        if direction == "out":
            kg, cg = key_plane[:, :, li], cw[:, :, li]  # [S, 2, nq, d]
        else:
            kg = key_plane[:, :, :, li].movedim(3, 2)
            cg = cw[:, :, :, li].movedim(3, 2)
        ia, ib, fa, fb = hsh.unpack_key(kg, F)
        idx, fp = (ia, fa) if direction == "out" else (ib, fb)
        match = (kg != EMPTY) & (idx == i) & (fp == f[None, None, :, None])
        w = w + _sum32(torch.where(match, cg, 0), (1, 3))
        if le is not None:
            lq = le.long()
            if direction == "out":  # gather the query's label only
                pg = pw[:, :, li, :, lq].permute(1, 2, 0, 3)  # [S, 2, nq, d]
            else:
                pg = pw[:, :, :, li, lq].movedim(3, 2)
            wl = wl + _sum32(torch.where(match, pg, 0), (1, 3))
    return w.to(torch.int32), wl.to(torch.int32)


def vertex_scan_kernel_sharded(lines, f, le, key_plane, cw, pw, *, r: int,
                               F: int, direction: str = "out"):
    if key_plane.device.type == "cpu":
        return vertex_scan_plain(lines, f, le, key_plane, cw, pw, r=r, F=F,
                                 direction=direction)
    if direction not in ("out", "in"):
        raise ValueError(f"unknown direction {direction!r}")
    build.check_cuda(lines, f, le, key_plane, cw, pw)
    S, _, d, _ = key_plane.shape
    nq = lines.shape[0]
    if tuple(lines.shape) != (nq, r) or tuple(f.shape) != (nq,) or \
            (le is not None and tuple(le.shape) != (nq,)) or \
            tuple(key_plane.shape) != (S, 2, d, d) or \
            cw.shape != key_plane.shape or pw.shape[:4] != key_plane.shape:
        raise ValueError("vertex scan: bad shapes")
    out = torch.empty((2, S, nq), dtype=torch.int32, device=key_plane.device)
    # the references in line order (4-int records), then the line counts,
    # offsets and each reference's rank in its line
    scratch = torch.empty(5 * nq * r + 2 * d + 1, dtype=torch.int32,
                          device=key_plane.device)
    build.call("lsk_vertex_scan", lines, f, le, key_plane, cw, pw, out[0],
               out[1], scratch, S, nq, r, d, pw.shape[-1], F,
               int(direction == "in"))
    vertex_scan_kernel_sharded.launches += 1
    return out[0], out[1]


vertex_scan_kernel_sharded.launches = 0
