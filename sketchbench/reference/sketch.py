"""The plain reference of the served sketch: LSketch's windowed first-fit
insert, additional pool, subwindow ring and time-sensitive queries,
written from the paper's rules in NumPy (the walks and the addressing) and
plain PyTorch (dense gathers and sums over the state's leaves, on
whatever device holds them). Nothing here imports the program.

State leaves (int32 tensors, ``R`` rows; a row is one shard of one
sketch, and a fleet is the set of rows one sketch's answers sum over):

    key [R, d, d, 2]  C [R, d, d, 2, k]  P [R, d, d, 2, k, c]
    pool_key [R, Q, 2]  pool_C [R, Q, k]  pool_P [R, Q, k, c]
    pool_lost [R]  slot_widx [R, k]  cur_widx [R]

``apply`` inserts one time-ordered batch whose items are already given
their rows (``rows_of``): per row, the subwindow ring claims a slot per
subwindow (a newer subwindow zeroes the slot's counters; only a slot's
final claimant in the batch counts), each live item of weight > 0 walks
its 2s candidate cells in probe order and lands on the first that holds
its key or is empty, and an item that finds none walks its pool slots in
stream order the same way (no slot: its weight is lost). Items of
different rows, and of different label tiles of one row, touch disjoint
cells, so the walk runs one lane per (row, tile). ``answer`` evaluates
edge, vertex and label queries over a fleet under the fleet's newest
subwindow.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import hashing as hsh

EMPTY = hsh.EMPTY
LEAVES = ("key", "C", "P", "pool_key", "pool_C", "pool_P", "pool_lost",
          "slot_widx", "cur_widx")
NEVER = -(2**30)


@dataclasses.dataclass(frozen=True)
class Config:
    d: int
    F: int
    r: int
    s: int
    c: int
    k: int
    window_size: int
    pool_capacity: int
    pool_probes: int
    n_blocks: int
    seed: int

    @property
    def subwindow(self) -> int:
        return max(1, self.window_size // self.k)

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        return cls(**{f.name: int(d[f.name]) for f in dataclasses.fields(cls)})


def empty_leaves(cfg: Config, R: int, device) -> dict:
    """A fresh all-empty state of ``R`` rows."""
    d, k, c, q = cfg.d, cfg.k, cfg.c, cfg.pool_capacity

    def full(shape, v):
        return torch.full((R,) + shape, v, dtype=torch.int32, device=device)

    return dict(key=full((d, d, 2), EMPTY), C=full((d, d, 2, k), 0),
                P=full((d, d, 2, k, c), 0), pool_key=full((q, 2), EMPTY),
                pool_C=full((q, k), 0), pool_P=full((q, k, c), 0),
                pool_lost=full((), 0), slot_widx=full((k,), NEVER),
                cur_widx=full((), NEVER))


def _lanes(keys: np.ndarray) -> np.ndarray:
    """Stream-order item indices grouped by lane id: ``[L, n_max]``, one
    row a lane, -1 padding."""
    order = np.argsort(keys, kind="stable")
    ids, starts, counts = np.unique(keys[order], return_index=True,
                                    return_counts=True)
    mat = np.full((len(ids), int(counts.max()) if len(ids) else 0), -1,
                  np.int64)
    pos = np.arange(len(order)) - np.repeat(starts, counts)
    mat[np.repeat(np.arange(len(ids)), counts), pos] = order
    return mat


def _ring(cfg: Config, slot_widx: np.ndarray, cur_widx: np.ndarray,
          rows: np.ndarray, widx: np.ndarray):
    """The ring's claims for items in stream order: per item whether its
    weight counts (its slot's final claimant in the batch) and its slot;
    the new ``slot_widx``/``cur_widx`` and the (row, slot) pairs to zero.
    An item of a subwindow older than its slot's holder is late: it
    neither claims nor counts."""
    k = cfg.k
    sw, cw = slot_widx.copy(), cur_widx.copy()
    slot = widx % k
    key_live = np.zeros(len(widx), bool)
    for row in np.unique(rows):
        sel = np.flatnonzero(rows == row)
        for w in np.unique(widx[sel]):  # ascending: the row's stream order
            j = w % k
            if w >= sw[row, j]:
                key_live[sel[widx[sel] == w]] = True
                sw[row, j] = w
                cw[row] = max(cw[row], w)
    count_live = key_live & (widx == sw[rows, slot])
    reset = np.argwhere(sw > slot_widx)
    return count_live, slot, sw, cw, reset


def apply(cfg: Config, st: dict, rows_of: np.ndarray, batch: dict) -> None:
    """Insert one time-ordered batch (host int arrays ``src``, ``dst``,
    ``src_label``, ``dst_label``, ``edge_label``, ``weight``, ``time``)
    into ``st`` in place; ``rows_of[i]`` is item i's row."""
    d, k, c, two_s = cfg.d, cfg.k, cfg.c, 2 * cfg.s
    dev = st["key"].device
    rows = np.asarray(rows_of, np.int64)
    n = len(rows)
    col = {f: np.asarray(v, np.int64) for f, v in batch.items()}
    widx = col["time"] // cfg.subwindow

    # the ring: zero what newer subwindows claim, commit the bookkeeping
    sw0 = st["slot_widx"].cpu().numpy().astype(np.int64)
    cw0 = st["cur_widx"].cpu().numpy().astype(np.int64)
    live, slot, sw, cw, reset = _ring(cfg, sw0, cw0, rows, widx)
    for row, j in reset:
        st["C"][row, :, :, :, j] = 0
        st["P"][row, :, :, :, j] = 0
        st["pool_C"][row, :, j] = 0
        st["pool_P"][row, :, j] = 0
    st["slot_widx"].copy_(torch.from_numpy(sw.astype(np.int32)))
    st["cur_widx"].copy_(torch.from_numpy(cw.astype(np.int32)))
    w = col["weight"] * live

    # the matrix walk over the candidate cells this batch can touch
    pr = hsh.edge_probes(cfg, col["src"], col["src_label"], col["dst"],
                         col["dst_label"])
    cell = (((rows[:, None] * d + pr["rows"]) * d + pr["cols"])[..., None]
            * 2 + np.arange(2)).reshape(n, two_s)  # probe-major, twin-minor
    cand_key = np.repeat(pr["keys"], 2, axis=1)
    act = np.flatnonzero(w > 0)
    uniq, inv = np.unique(cell[act], return_inverse=True)
    local = np.full((n, two_s), -1, np.int64)
    local[act] = inv.reshape(len(act), two_s)
    key_flat = st["key"].view(-1)
    ukey = torch.from_numpy(uniq).to(dev)
    kl = key_flat[ukey].cpu().numpy().astype(np.int64)
    kl0 = kl.copy()
    landed = np.full(n, -1, np.int64)  # the landing cell's local index
    mat = _lanes(rows[act] * cfg.n_blocks ** 2 + pr["tile"][act])
    for t in range(mat.shape[1]):
        it = act[mat[:, t][mat[:, t] >= 0]]
        loc = local[it]
        cur = kl[loc]
        ok = (cur == cand_key[it]) | (cur == EMPTY)
        found = ok.any(1)
        first = ok.argmax(1)
        it, land = it[found], loc[found, first[found]]
        kl[land] = cand_key[it, first[found]]
        landed[it] = land
    changed = np.flatnonzero(kl != kl0)
    key_flat[ukey[torch.from_numpy(changed).to(dev)]] = torch.from_numpy(
        kl[changed].astype(np.int32)).to(dev)
    le = hsh.edge_label_bucket(cfg, col["edge_label"])
    ins = np.flatnonzero(landed >= 0)
    gcell = uniq[landed[ins]]
    _add(st["C"], gcell * k + slot[ins], w[ins])
    _add(st["P"], (gcell * k + slot[ins]) * c + le[ins], w[ins])

    # the pool walk: the rejected items of each row in stream order
    rej = act[landed[act] < 0]
    pk = st["pool_key"].cpu().numpy().astype(np.int64)
    ps = hsh.pool_slots(cfg, pr["pid_src"], pr["pid_dst"])
    plost = np.zeros(st["pool_lost"].shape[0], np.int64)
    pland = np.full(n, -1, np.int64)
    pmat = _lanes(rows[rej])
    for t in range(pmat.shape[1]):
        it = rej[pmat[:, t][pmat[:, t] >= 0]]
        r_, sl_ = rows[it][:, None], ps[it]
        kk = pk[r_, sl_]  # [a, probes, 2]
        match = (kk[..., 0] == pr["pid_src"][it, None]) & \
            (kk[..., 1] == pr["pid_dst"][it, None])
        ok = match | (kk[..., 0] == EMPTY)
        found = ok.any(1)
        slot_p = sl_[np.arange(len(it)), ok.argmax(1)]
        np.add.at(plost, rows[it[~found]], w[it[~found]])
        it, slot_p = it[found], slot_p[found]
        pk[rows[it], slot_p, 0] = pr["pid_src"][it]
        pk[rows[it], slot_p, 1] = pr["pid_dst"][it]
        pland[it] = slot_p
    st["pool_key"].copy_(torch.from_numpy(pk.astype(np.int32)))
    pin = np.flatnonzero(pland >= 0)
    prow = rows[pin] * cfg.pool_capacity + pland[pin]
    _add(st["pool_C"], prow * k + slot[pin], w[pin])
    _add(st["pool_P"], (prow * k + slot[pin]) * c + le[pin], w[pin])
    st["pool_lost"].add_(torch.from_numpy(plost.astype(np.int32)).to(dev))


def _add(leaf: torch.Tensor, flat_idx: np.ndarray, vals: np.ndarray) -> None:
    """``leaf.view(-1)[flat_idx] += vals`` with repeated indices summed."""
    if len(flat_idx) == 0:
        return
    u, inv = np.unique(flat_idx, return_inverse=True)
    tot = np.bincount(inv, weights=vals).astype(np.int64)
    dev = leaf.device
    leaf.view(-1).index_add_(0, torch.from_numpy(u).to(dev),
                             torch.from_numpy(tot.astype(np.int32)).to(dev))


# --------------------------------------------------------------------------
# queries
# --------------------------------------------------------------------------

def _valid(cfg: Config, st: dict, fleet, last) -> torch.Tensor:
    """bool [len(fleet), k]: the slots inside the horizon under the
    fleet's newest subwindow."""
    h = cfg.k if last is None else min(int(last), cfg.k)
    sw = st["slot_widx"][fleet]
    return sw > (st["cur_widx"][fleet].max() - h)


def _t(x, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, np.int64)).to(dev)


def _edge(cfg, st, fleet, q, with_le, last) -> np.ndarray:
    dev = st["key"].device
    n = len(q["src"])
    pr = hsh.edge_probes(cfg, q["src"], q["la"], q["dst"], q["lb"])
    rr, cc, kk = (_t(pr[f], dev) for f in ("rows", "cols", "keys"))
    ps = _t(hsh.pool_slots(cfg, pr["pid_src"], pr["pid_dst"]), dev)
    pids, pidd = _t(pr["pid_src"], dev), _t(pr["pid_dst"], dev)
    le = _t(hsh.edge_label_bucket(cfg, q["le"]), dev) if with_le else None
    tz = torch.arange(2, device=dev)
    ar = torch.arange(n, device=dev)
    total = torch.zeros(n, dtype=torch.int64, device=dev)
    valid = _valid(cfg, st, fleet, last)
    for j, row in enumerate(fleet):
        cur = st["key"][row][rr[..., None], cc[..., None], tz].reshape(n, -1)
        match = cur == kk.repeat_interleave(2, 1)
        stop = match | (cur == EMPTY)
        first = stop.to(torch.uint8).argmax(1)
        hit = stop.any(1) & match[ar, first]
        r1, c1, t1 = rr[ar, first // 2], cc[ar, first // 2], first % 2
        vals = st["P"][row][r1, c1, t1, :, le] if with_le \
            else st["C"][row][r1, c1, t1]
        w = torch.where(valid[j], vals, 0).sum(1)
        pk = st["pool_key"][row][ps]  # [n, probes, 2]
        pm = (pk[..., 0] == pids[:, None]) & (pk[..., 1] == pidd[:, None])
        pslot = ps[ar, pm.to(torch.uint8).argmax(1)]
        pv = st["pool_P"][row][pslot, :, le] if with_le \
            else st["pool_C"][row][pslot]
        wp = torch.where(valid[j], pv, 0).sum(1)
        total += torch.where(hit, w, 0) + \
            torch.where(~stop.any(1) & pm.any(1), wp, 0)
    return total.cpu().numpy()


def _vertex(cfg, st, fleet, q, with_le, last, direction,
            chunk: int = 64) -> np.ndarray:
    dev = st["key"].device
    a = hsh.addressing(cfg, q["v"], q["lv"])
    lines_all, f_all = _t(a["lines"], dev), _t(a["f"], dev)
    vid = _t(a["vid"], dev)
    le_all = _t(hsh.edge_label_bucket(cfg, q["le"]), dev) if with_le else None
    n, d, k = len(q["v"]), cfg.d, cfg.k
    want_i = torch.arange(cfg.r, device=dev)[None, :, None, None]
    J = torch.arange(d, device=dev)[None, None, :, None, None]
    T = torch.arange(2, device=dev)[None, None, None, :, None]
    K = torch.arange(k, device=dev)[None, None, None, None, :]
    valid = _valid(cfg, st, fleet, last)
    total = torch.zeros(n, dtype=torch.int64, device=dev)
    pcol = 0 if direction == "out" else 1
    for j, row in enumerate(fleet):
        key, C, P = st["key"][row], st["C"][row], st["P"][row]
        for a0 in range(0, n, chunk):
            ln = lines_all[a0:a0 + chunk]
            L = ln[:, :, None, None, None]
            if direction == "out":
                keys = key[ln]  # [b, r, d, 2]
                ij = (L, J)
            else:
                keys = key[:, ln].permute(1, 2, 0, 3)
                ij = (J, L)
            ia, ib, fa, fb = (torch.div(keys, cfg.F ** 2 * hsh.IDX_RADIX,
                                        rounding_mode="floor"),
                              torch.div(keys, cfg.F ** 2,
                                        rounding_mode="floor") % hsh.IDX_RADIX,
                              torch.div(keys, cfg.F,
                                        rounding_mode="floor") % cfg.F,
                              keys % cfg.F)
            idx, fp = (ia, fa) if direction == "out" else (ib, fb)
            f = f_all[a0:a0 + chunk][:, None, None, None]
            match = (keys != EMPTY) & (idx == want_i) & (fp == f)
            if with_le:
                lq = le_all[a0:a0 + chunk][:, None, None, None, None]
                vals = P[ij[0], ij[1], T, K, lq]
            else:
                vals = C[ij[0], ij[1], T, K]
            tot = torch.where(valid[j], vals, 0).sum(-1)
            total[a0:a0 + chunk] += torch.where(match, tot, 0).sum((1, 2, 3))
        pm = st["pool_key"][row][:, pcol][None, :] == vid[:, None]  # [n, Q]
        if with_le:
            pv = torch.where(valid[j][None, :, None], st["pool_P"][row],
                             0).sum(1)[:, le_all].T  # [n, Q]
        else:
            pv = torch.where(valid[j], st["pool_C"][row], 0).sum(1)[None]
        total += torch.where(pm, pv, 0).sum(1)
    return total.cpu().numpy()


def _label(cfg, st, fleet, q, with_le, last, direction) -> np.ndarray:
    dev = st["key"].device
    b = cfg.d // cfg.n_blocks
    m = _t(hsh.vertex_block(cfg, q["lv"]), dev)
    le = _t(hsh.edge_label_bucket(cfg, q["le"]), dev) if with_le else None
    n = len(q["lv"])
    valid = _valid(cfg, st, fleet, last)
    total = torch.zeros(n, dtype=torch.int64, device=dev)
    line = torch.arange(cfg.d, device=dev)
    in_block = (line[None, :] // b) == m[:, None]  # [n, d]
    sum_dims = (1, 2) if direction == "out" else (0, 2)
    pcol = 0 if direction == "out" else 1
    for j, row in enumerate(fleet):
        occ = st["key"][row] != EMPTY
        slots = torch.nonzero(valid[j]).flatten().tolist()
        if with_le:
            acc = torch.zeros(st["P"].shape[1:4] + (cfg.c,),
                              dtype=torch.int64, device=dev)
            for sl in slots:
                acc += st["P"][row][:, :, :, sl]
            per_line = torch.where(occ[..., None], acc, 0).sum(sum_dims)
            del acc
            lw = per_line[:, le].T  # [n, d]
        else:
            acc = torch.zeros(st["C"].shape[1:4], dtype=torch.int64,
                              device=dev)
            for sl in slots:
                acc += st["C"][row][:, :, :, sl]
            lw = torch.where(occ, acc, 0).sum(sum_dims)[None]
        total += torch.where(in_block, lw, 0).sum(1)
        pid = st["pool_key"][row][:, pcol]
        pblock = torch.div(pid, cfg.F * 2048, rounding_mode="floor")
        pm = (pid != EMPTY)[None, :] & (pblock[None, :] == m[:, None])
        if with_le:
            pv = torch.where(valid[j][None, :, None], st["pool_P"][row],
                             0).sum(1)[:, le].T
        else:
            pv = torch.where(valid[j], st["pool_C"][row], 0).sum(1)[None]
        total += torch.where(pm, pv, 0).sum(1)
    return total.cpu().numpy()


def answer(cfg: Config, st: dict, fleet, kind: str, q: dict,
           with_le: bool, last=None, direction: str = "out") -> np.ndarray:
    """Answers (int64 [n]) of one homogeneous group of queries over the
    rows ``fleet``. ``q`` holds host arrays: ``src``, ``la``, ``dst``,
    ``lb`` (edge), ``v``, ``lv`` (vertex), ``lv`` (label), and ``le``
    where ``with_le``."""
    fleet = list(fleet)
    if kind == "edge":
        out = _edge(cfg, st, fleet, q, with_le, last)
    elif kind == "vertex":
        out = _vertex(cfg, st, fleet, q, with_le, last, direction)
    elif kind == "label":
        out = _label(cfg, st, fleet, q, with_le, last, direction)
    else:
        raise ValueError(f"unknown query kind {kind!r}")
    return hsh._wrap32(out)
