"""Cell-owner decode of window-reduced key planes: CUDA kernel wrapper and
plain version.

``cell_decode_kernel_sharded`` replaces the TPU kernel
``repro/kernels/heavy_hitters/kernel.py::cell_decode_kernel_sharded``
(source: ``csrc/cell_decode.cu``, one block per (shard, twin, row) line;
what bounds it is noted there). ``cell_decode_plain`` is the vectorized
PyTorch twin (counterpart of ``cell_decode_xla``) on the shared
``hashing.decode_line_vid`` seam, whose chain replay keeps the transient
to a few plane-sized int64 tensors. The wrapper takes the plain version
only for CPU tensors; for CUDA tensors it launches the kernel or raises.

key_plane [S, 2, d, d] int32 (twin-leading QueryPlanes layout);
``starts``/``widths`` the block partition as int sequences. Returns
(vid_src, vid_dst), each [S, 2, d, d] int32, EMPTY (-1) where the cell is
unoccupied.
"""

from __future__ import annotations

import torch

from repro_torch.core import hashing as hsh
from repro_torch.core.types import EMPTY
from repro_torch.kernels import build


def cell_decode_plain(key_plane, *, starts, widths, r: int, F: int):
    d = key_plane.shape[-1]
    dev = key_plane.device
    st = torch.as_tensor(starts, dtype=torch.int32, device=dev)
    wd = torch.as_tensor(widths, dtype=torch.int32, device=dev)
    line = torch.arange(d, dtype=torch.int32, device=dev)
    ia, ib, fa, fb = hsh.unpack_key(key_plane, F)
    empty = key_plane == EMPTY
    vs = hsh.decode_line_vid(line[:, None], ia, fa, st, wd, r, F)
    vd = hsh.decode_line_vid(line[None, :], ib, fb, st, wd, r, F)
    return vs.masked_fill_(empty, EMPTY), vd.masked_fill_(empty, EMPTY)


_BLOCK_TABLES: dict = {}


def _block_table(dev, starts, widths):
    """The block partition as int32 tensors on ``dev``, copied there once
    (a copy per launch would sit between the kernel's timing events)."""
    key = (dev, starts, widths)
    if key not in _BLOCK_TABLES:
        _BLOCK_TABLES[key] = tuple(torch.tensor(x, dtype=torch.int32,
                                                device=dev)
                                   for x in (starts, widths))
    return _BLOCK_TABLES[key]


def cell_decode_kernel_sharded(key_plane, *, starts, widths, r: int, F: int):
    if key_plane.device.type == "cpu":
        return cell_decode_plain(key_plane, starts=starts, widths=widths,
                                 r=r, F=F)
    build.check_cuda(key_plane)
    S, two, d, d2 = key_plane.shape
    if two != 2 or d2 != d or len(starts) != len(widths) or not starts:
        raise ValueError(f"bad decode inputs: key_plane "
                         f"{tuple(key_plane.shape)}, {len(starts)} starts, "
                         f"{len(widths)} widths")
    st, wd = _block_table(key_plane.device, tuple(starts), tuple(widths))
    vs, vd = torch.empty_like(key_plane), torch.empty_like(key_plane)
    build.call("lsk_cell_decode", key_plane, st, wd, vs, vd, S, d,
               len(starts), r, F)
    cell_decode_kernel_sharded.launches += 1
    return vs, vd


cell_decode_kernel_sharded.launches = 0
