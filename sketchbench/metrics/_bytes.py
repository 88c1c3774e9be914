"""Bytes each kernel launch must move, each input byte read once and each
output byte written once, over what these inputs need (the arithmetic of
the repository's card smoke run, ``chip_smoke.py``'s ``insert_nbytes``,
``pool_nbytes``, ``probe_nbytes``, ``scan_nbytes`` and
``grouped_nbytes``, copied and adapted to launches captured in a trace),
and the roofline share they give. Only the bandwidth bound applies:
these kernels do no arithmetic worth a FLOP bound.

Where a count needs the state a launch saw, it uses a later one and the
sketch's rule that a claimed key cell or pool slot never changes again:
an edge's landing is the first of its candidates whose key is the edge's
in any later key plane (the earlier ones held other keys then and still
do), and an item that finds none never landed. The pool's key writes
are counted once over the traced part, as the slots whose pair changed
between its start and its end.
"""

from __future__ import annotations

import numpy as np
import torch

from sketchbench.reference import hashing as hsh

# NVIDIA H100 SXM, HBM3 (the data sheet's peak; the card's power limit is
# printed beside every run)
HBM_BYTES_PER_S = 3.35e12


def n_distinct(ids: torch.Tensor) -> int:
    return int(torch.unique(ids).numel())


def insert_nbytes(cfg, args, key_later) -> int:
    """The insert kernel: per walked edge its order entry, s probe
    coordinates and keys, weight and label; each (shard, bin)'s offset and
    count; the distinct candidate key cells of the live edges (both
    twins); each distinct landing cell's key write and C read-modify-write
    and each distinct (cell, label)'s P; one flag per row."""
    rows, cols, keys, w, le, slot, order, offs, counts = args[:9]
    max_bin = args[12]
    S, B, s = rows.shape
    d, dev = cfg.d, rows.device
    walked = int(counts.clamp(max=max_bin).sum())
    live = w > 0
    sh = torch.arange(S, device=dev)[:, None, None]
    cells = (sh * d + rows.long()) * d + cols.long()  # [S, B, s]
    tz = torch.arange(2, device=dev)
    n_cand = n_distinct(cells[live][..., None] * 2 + tz)
    cur = key_later[sh[..., None], rows.long()[..., None],
                    cols.long()[..., None], tz]  # [S, B, s, 2]
    match = (cur == keys[..., None]).reshape(S, B, 2 * s)
    landed = live & match.any(-1)
    first = match.to(torch.uint8).argmax(-1)
    cell2 = (cells[..., None] * 2 + tz).reshape(S, B, 2 * s)
    win = cell2.gather(-1, first[..., None])[..., 0][landed]
    n_win = n_distinct(win)
    n_win_le = n_distinct(win * cfg.c + le[landed].long())
    return walked * (4 + 3 * s * 4 + 8) + 2 * counts.numel() * 4 + \
        n_cand * 4 + n_win * (4 + 8) + n_win_le * 8 + S * B


def pool_nbytes(cfg, args, kw, pool_key_later) -> int:
    """The pool pass, without its key writes (``pool_key_writes``): the
    eligible flags; per eligible item its six scalars; the distinct pool
    rows its walk reads up to its landing (all its probes when it lands
    nowhere); each distinct (slot, ring slot) of pool_C and (slot, ring
    slot, label) of pool_P it adds to; pool_lost."""
    pid_s, pid_d, w_count, _, sl, le, elig = (a for a in args[:7])
    S, B = pid_s.shape
    Q, probes = pool_key_later.shape[1], kw["probes"]
    m = elig.bool().cpu().numpy()
    sh = np.nonzero(m)[0]
    ps_, pd_ = pid_s.cpu().numpy()[m], pid_d.cpu().numpy()[m]
    ps = hsh.pool_slots(cfg, ps_, pd_)  # [n, probes]
    pk = pool_key_later.cpu().numpy()[sh[:, None], ps]  # [n, probes, 2]
    match = (pk[..., 0] == ps_[:, None]) & (pk[..., 1] == pd_[:, None])
    landed = match.any(1)
    upto = np.where(landed, match.argmax(1) + 1, probes)
    read = (sh[:, None] * Q + ps)[np.arange(probes)[None, :] < upto[:, None]]
    slot = (sh * Q + ps[np.arange(len(sh)), match.argmax(1)])[landed]
    wc = w_count.cpu().numpy()[m][landed]
    slot = slot[wc > 0]
    ring = sl.cpu().numpy()[m][landed][wc > 0]
    lab = le.cpu().numpy()[m][landed][wc > 0]
    n_c = len(np.unique(slot * cfg.k + ring))
    n_p = len(np.unique((slot * cfg.k + ring) * cfg.c + lab))
    return S * B * 4 + len(sh) * 6 * 4 + len(np.unique(read)) * 8 + \
        (n_c + n_p) * 8 + S * 4


def pool_key_writes(pool_key_before, pool_key_after) -> int:
    """The pool's key writes over the traced part: each slot whose pair
    changed, written once."""
    if pool_key_before is None:
        return 0
    return int((pool_key_before != pool_key_after).any(-1).sum()) * 8


def probe_nbytes(cfg, key, pool_key, src, la, dst, lb, le, H: int = 1
                 ) -> int:
    """The fused edge-probe entry for one block of shard rows (``key``
    ``[S, 2, d, d]``, ``pool_key`` ``[S, Q, 2]``): the raw query columns
    and the block table; the distinct key cells the walks visit up to and
    including each stop; cw (and pw, with a label) of each distinct hit
    cell; the pool pairs of every probe of a walk without a stop and the
    counters of each distinct matching slot; the outputs."""
    S, _, d, _ = key.shape
    Q = pool_key.shape[1]
    dev = key.device
    nq = len(src)
    pr = hsh.edge_probes(cfg, src, la, dst, lb)
    rows = torch.from_numpy(pr["rows"]).to(dev)
    cols = torch.from_numpy(pr["cols"]).to(dev)
    keys = torch.from_numpy(pr["keys"]).to(dev)
    cur = key[:, :, rows, cols].movedim(1, -1)  # [S, nq, s, 2]
    match = (cur == keys[None, :, :, None]).reshape(S, nq, -1)
    stop = match | (cur == -1).reshape(S, nq, -1)
    first = stop.to(torch.uint8).argmax(-1, keepdim=True)
    any_stop = stop.any(-1)
    visited = torch.where(any_stop[..., None], first + 1, stop.shape[-1])
    shv = torch.arange(S, device=dev)[:, None, None, None]
    ids = (((shv * 2 + torch.arange(2, device=dev)) * d +
            rows[None, :, :, None]) * d + cols[None, :, :, None]
           ).reshape(S, nq, -1)
    seen = torch.arange(stop.shape[-1], device=dev) < visited
    hit = any_stop & match.gather(-1, first)[..., 0]
    hit_ids = ids.gather(-1, first)[..., 0][hit]
    lab = None if le is None else torch.from_numpy(
        hsh.edge_label_bucket(cfg, le)).to(dev)
    counters = n_distinct(hit_ids)
    if lab is not None:
        counters += n_distinct(hit_ids * cfg.c + lab[None, :].expand(
            S, -1)[hit])
    ps = torch.from_numpy(hsh.pool_slots(cfg, pr["pid_src"],
                                         pr["pid_dst"])).to(dev)
    slots = torch.arange(S, device=dev)[:, None, None] * Q + ps
    go = ~any_stop
    pk = pool_key[:, ps]  # [S, nq, probes, 2]
    pids = torch.from_numpy(pr["pid_src"]).to(dev)
    pidd = torch.from_numpy(pr["pid_dst"]).to(dev)
    pm = (pk[..., 0] == pids[None, :, None]) & (pk[..., 1] == pidd[None, :,
                                                                   None])
    won = go & pm.any(-1)
    wslot = slots.gather(-1, pm.to(torch.uint8).argmax(-1, keepdim=True)
                         )[..., 0][won]
    counters += n_distinct(wslot)
    if lab is not None:
        counters += n_distinct(wslot * cfg.c + lab[None, :].expand(
            S, -1)[won])
    n_cols = 4 if le is None else 5
    return nq * n_cols * 4 + 2 * cfg.n_blocks * 4 + \
        n_distinct(ids[seen]) * 4 + n_distinct(slots[go]) * 8 + \
        H * (counters * 4 + 2 * S * nq * 4)


def scan_nbytes(cfg, lines, f, le, key_plane, direction) -> int:
    """The vertex scan for one block of shard rows: every row's keys on
    the distinct lines the batch scans, cw of each distinct matching cell
    and pw of each distinct (matching cell, label), the per-query inputs
    and the two outputs."""
    S, _, d, _ = key_plane.shape
    nq = lines.shape[0]
    dev = key_plane.device
    base = (torch.arange(S, device=dev)[:, None, None, None] * 2 +
            torch.arange(2, device=dev)[:, None, None]) * d
    j = torch.arange(d, device=dev)
    cells, cells_le = [], []
    for i in range(cfg.r):
        li = lines[:, i].long()
        if direction == "out":
            kg = key_plane[:, :, li]  # [S, 2, nq, d]
            cell = (base + li[:, None]) * d + j
        else:
            kg = key_plane[:, :, :, li].movedim(3, 2)
            cell = (base + j) * d + li[:, None]
        kk = kg.long()
        rest = torch.div(kk, cfg.F, rounding_mode="floor")
        idx = torch.div(rest, cfg.F, rounding_mode="floor")
        if direction == "out":
            ci, fp = torch.div(idx, hsh.IDX_RADIX, rounding_mode="floor"), \
                rest % cfg.F
        else:
            ci, fp = idx % hsh.IDX_RADIX, kk % cfg.F
        match = (kg != -1) & (ci == i) & (fp == f[None, None, :, None])
        cells.append(cell.expand_as(match)[match])
        if le is not None:
            lq = le[None, None, :, None].long()
            cells_le.append((cell * cfg.c + lq).expand_as(match)[match])
    n = S * n_distinct(lines) * 2 * d * 4 + \
        n_distinct(torch.cat(cells)) * 4 + nq * (cfg.r + 2) * 4 + \
        2 * S * nq * 4
    if le is not None:
        n += n_distinct(torch.cat(cells_le)) * 4
    return n


def write_bytes(cfg, captures, key_later, pool_key_before, pool_key_after
                ) -> int:
    """Every captured insert and pool-pass launch of the traced part."""
    n = sum(insert_nbytes(cfg, a, key_later) for a, _ in captures["insert"])
    n += sum(pool_nbytes(cfg, a, kw, pool_key_after)
             for a, kw in captures["pool"])
    return n + pool_key_writes(pool_key_before, pool_key_after)


def read_bytes(cfg, captures, pool_key_after) -> int:
    """Every captured edge-probe and vertex-scan launch of the traced part,
    each group's block of rows against its own queries (the block table
    counted once a launch)."""
    total = 0
    for (_, key, H, src, la, dst, lb, le), kw in captures["probe"]:
        G = kw.get("groups", 1)
        S = key.shape[0]
        per, Lq = S // G, src.shape[0] // G
        host = [x.cpu().numpy().astype(np.int64) if x is not None else None
                for x in (src, la, dst, lb, le)]
        for g in range(G):
            rs, qs = slice(g * per, (g + 1) * per), slice(g * Lq, (g + 1) * Lq)
            q = [None if x is None else x[qs] for x in host]
            total += probe_nbytes(cfg, key[rs], pool_key_after[rs], *q, H=H)
        total -= (G - 1) * 2 * cfg.n_blocks * 4
    for (lines, f, le, key_plane), kw in captures["scan"]:
        G = kw.get("groups", 1)
        S, per = key_plane.shape[0], key_plane.shape[0] // G
        Lq = lines.shape[0] // G
        for g in range(G):
            rs, qs = slice(g * per, (g + 1) * per), slice(g * Lq, (g + 1) * Lq)
            total += scan_nbytes(cfg, lines[qs], f[qs],
                                 None if le is None else le[qs],
                                 key_plane[rs], kw.get("direction", "out"))
    return total


def share(nbytes: int, device_s: float):
    """Percent of the bandwidth bound, or None when no launch was timed."""
    if device_s <= 0 or nbytes <= 0:
        return None
    return 100.0 * nbytes / HBM_BYTES_PER_S / device_s
