"""The query sampler: a workload's request mix, drawn from the seed.

Each request's random draws are made up front (``draws``), so the mix is
fixed by the seed; what a request asks about is read from its stream at
the moment it is issued: an edge query names an edge of the current
window (or, with ``random_pair_share``, a random pair, which misses the
matrix and goes on to the pool lookup), a vertex query an endpoint of one
(the source for ``out``, the destination for ``in``), a label query a
uniform vertex label. With ``edge_label_share`` a request carries an edge
label (the sampled edge's own for an in-window edge), and ``lasts`` gives
its horizon (``null`` for the whole window).
"""

from __future__ import annotations

import numpy as np

from .stream import Replay

N_DRAWS = 9
KINDS = ("edge", "vertex", "label")


def draws(rng: np.random.Generator, n: int) -> np.ndarray:
    """``[n, N_DRAWS]`` uniforms, one row a request."""
    return rng.random((n, N_DRAWS))


def sample_many(mix: dict, u: np.ndarray, replay: Replay, pos: int,
                window_edges: int) -> list:
    """Requests from their draws ``u`` (``[n, N_DRAWS]``) against
    ``replay`` whose first ``pos`` items are ingested: ``(kind, args)``
    pairs as a server takes them."""
    p = replay.p
    n = u.shape[0]
    shares = np.cumsum([mix["edge"], mix["vertex"], mix["label"]])
    kind = np.searchsorted(shares, u[:, 0] * shares[-1], side="right")
    lasts = mix["lasts"]
    last_i = np.minimum((u[:, 2] * len(lasts)).astype(np.int64),
                        len(lasts) - 1)
    with_le = u[:, 1] < mix["edge_label_share"]
    lo = max(0, pos - window_edges)
    e = replay.at(lo + np.minimum((u[:, 3] * (pos - lo)).astype(np.int64),
                                  pos - lo - 1))
    rand = u[:, 4] < mix["random_pair_share"]
    nv, nvl, nel = p.n_vertices, p.n_vertex_labels, p.n_edge_labels
    rs, rd = (u[:, 5] * nv).astype(np.int64), (u[:, 6] * nv).astype(np.int64)
    rla = (u[:, 7] * nvl).astype(np.int64)
    rlb = (u[:, 8] * nvl).astype(np.int64)
    rle = (u[:, 5] * 7919 * nel).astype(np.int64) % nel
    out_dir = u[:, 4] < 0.5
    lab_lv = (u[:, 5] * nvl).astype(np.int64)
    lab_le = (u[:, 6] * nel).astype(np.int64)
    col = {f: v.tolist() for f, v in e.items()}
    out = []
    for i in range(n):
        k = KINDS[kind[i]]
        if k == "edge":
            if rand[i]:
                args = dict(src=int(rs[i]), la=int(rla[i]), dst=int(rd[i]),
                            lb=int(rlb[i]))
                le = int(rle[i])
            else:
                args = dict(src=col["src"][i], la=col["src_label"][i],
                            dst=col["dst"][i], lb=col["dst_label"][i])
                le = col["edge_label"][i]
        elif k == "vertex":
            args = (dict(v=col["src"][i], lv=col["src_label"][i],
                         direction="out") if out_dir[i] else
                    dict(v=col["dst"][i], lv=col["dst_label"][i],
                         direction="in"))
            le = col["edge_label"][i]
        else:
            args = dict(lv=int(lab_lv[i]),
                        direction="out" if u[i, 8] < 0.5 else "in")
            le = int(lab_le[i])
        if with_le[i]:
            args["le"] = le
        if lasts[last_i[i]] is not None:
            args["last"] = int(lasts[last_i[i]])
        out.append((k, args))
    return out
