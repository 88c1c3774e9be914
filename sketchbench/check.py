"""The comparison that decides ``correct``.

The reference (``reference/sketch.py``) cannot replay a run from its
first edge within a run's time: the key matrix keeps every key it ever
claimed, so the state at the window's close depends on every edge since
set-up began, a hundred million of them, and the reference inserts a
batch of 262,144 in about a second and a half. It therefore checks
three stretches, each from a state it holds by itself:

* ``start``: the first batch of set-up, into the empty state: the
  reference's state after it, built from nothing, against the program's,
  every leaf;
* ``span``: the window's last ``harness.SPAN_S`` seconds, timed rounds of
  the cell's own serve loop. Where the span begins, the pipeline is
  drained and the program's state copied; the reference then applies
  each round's batches to the copy in order, answers each flush's
  requests on its own state at that point, and at the close compares
  every leaf (``pool_lost`` included) with the program's;
* ``rounds``: after the window, the serve loop goes on, and for a round
  whose planes the program folds and one it rebuilds: the program's
  state before the round is copied, the program serves the round (its
  ingest at the cell's batch size, then a flush of the cell's
  requests), and the reference applies the round's batches to the copy:
  every leaf and every answer against the program's.

What no stretch sees: a leaf that an earlier batch of the window
corrupted, and that no later round overwrites, is in the span's starting
state on both sides.

Each number compared is a count of elements or answers that differ, held
to the limit 0: the comparison is exact, as the sketch's int32 counters
are. ``CONTROL`` names what the control run breaks: it answers the
round's requests from the state before the round's batches (a stale read,
which the server's guarantee that answers reflect every submitted batch
rules out).
"""

from __future__ import annotations

import numpy as np
import torch

from sketchbench.reference import sketch as ref

LIMITS = {"start_state_mismatch": 0, "span_state_mismatch": 0,
          "span_answer_mismatch": 0, "round_state_mismatch": 0,
          "round_answer_mismatch": 0}
CONTROL = "stale"


def clone_leaves(leaves: dict) -> dict:
    return {k: v.clone() for k, v in leaves.items()}


def leaf_mismatch(got: dict, want: dict, block: int = 1 << 26) -> int:
    """Elements that differ, over every leaf (compared a block of
    ``block`` elements at a time, so no leaf-sized mask is made)."""
    n = 0
    for k in ref.LEAVES:
        a, b = got[k].reshape(-1), want[k].reshape(-1)
        for i in range(0, a.numel(), block):
            n += int(torch.count_nonzero(a[i:i + block] != b[i:i + block]))
    return n


def group(reqs) -> dict:
    """Requests grouped as the reference answers them: by fleet, kind,
    edge label presence, horizon and direction."""
    out = {}
    for i, (fleet, kind, args) in enumerate(reqs):
        key = (tuple(fleet), kind, "le" in args, args.get("last"),
               args.get("direction", "out"))
        out.setdefault(key, []).append(i)
    return out


def reference_answers(cfg, leaves: dict, reqs) -> np.ndarray:
    """The reference's answer to each ``(fleet rows, kind, args)``."""
    out = np.zeros(len(reqs), np.int64)
    cols = {"edge": ("src", "la", "dst", "lb"), "vertex": ("v", "lv"),
            "label": ("lv",)}
    for (fleet, kind, with_le, last, direction), idx in group(reqs).items():
        names = cols[kind] + (("le",) if with_le else ())
        q = {n: np.array([reqs[i][2][n] for i in idx], np.int64)
             for n in names}
        out[idx] = ref.answer(cfg, leaves, fleet, kind, q, with_le, last,
                              direction)
    return out


def answer_mismatch(cfg, leaves: dict, reqs, got) -> int:
    if not reqs:
        return 0
    want = reference_answers(cfg, leaves, reqs)
    return int((np.asarray(got, np.int64) != want).sum())
