"""The kernels' byte counts against small launches counted by hand."""

import numpy as np
import torch

from sketchbench.metrics import _bytes
from sketchbench.reference import hashing as rh
from sketchbench.reference.sketch import Config

CFG = Config(d=4, F=1024, r=2, s=2, c=2, k=2, window_size=4,
             pool_capacity=8, pool_probes=2, n_blocks=1, seed=1234)


def i32(x):
    return torch.tensor(x, dtype=torch.int32)


def test_insert_bytes_of_a_small_flush():
    # three edges, the last dead (weight 0); the first two share their
    # key and land on cell (0, 0)'s first twin
    rows, cols = i32([[[0, 1], [0, 1], [2, 3]]]), i32([[[0, 0], [0, 0],
                                                         [1, 1]]])
    keys = i32([[[10, 11], [10, 11], [20, 21]]])
    w, le = i32([[1, 1, 0]]), i32([[0, 1, 0]])
    counts = i32([[2]])
    key = torch.full((1, 4, 4, 2), -1, dtype=torch.int32)
    key[0, 0, 0, 0] = 10
    args = (rows, cols, keys, w, le, i32([0]), i32([[0, 1, 2]]), i32([[0]]),
            counts, key, None, None, 3)
    # walked 2 x (order 4 + 2 probes x 3 ints x 4 + weight and label 8)
    # + one bin's offset and count 8 + 4 candidate cells x 4 + one landing
    # cell (key 4, C 8) + two (cell, label) P 16 + 3 flags
    assert _bytes.insert_nbytes(CFG, args, key) == 72 + 8 + 16 + 12 + 16 + 3


def test_pool_bytes_of_a_small_pass():
    ps = rh.pool_slots(CFG, np.array([7]), np.array([9]))[0]
    pk = torch.full((1, 8, 2), -1, dtype=torch.int32)
    pk[0, ps[0]] = i32([1, 2])  # another pair holds its first probe
    pk[0, ps[1]] = i32([7, 9])  # it lands on its second
    args = (i32([[7, 3]]), i32([[9, 4]]), i32([[1, 1]]), i32([[1, 1]]),
            i32([[1, 0]]), i32([[1, 0]]), i32([[1, 0]]))
    # flags 2 x 4 + one item's six scalars 24 + two rows read 16
    # + one pool_C and one pool_P element 16 + pool_lost 4
    assert _bytes.pool_nbytes(CFG, args, {"probes": 2}, pk) == 8 + 24 + \
        16 + 16 + 4
    before = pk.clone()
    before[0, ps[1]] = -1
    assert _bytes.pool_key_writes(before, pk) == 8


def test_scan_bytes_of_a_small_batch():
    F = CFG.F
    plane = torch.full((1, 2, 4, 4), -1, dtype=torch.int32)
    plane[0, 0, 0, 3] = ((0 * 16 + 1) * F + 5) * F + 7  # index 0, f 5
    plane[0, 1, 2, 1] = ((0 * 16 + 1) * F + 5) * F + 7  # index 0 on line 2
    lines, f, le = i32([[0, 2]]), i32([5]), i32([1])
    # 2 lines x 2 twins x 4 columns x 4 + one matching cell's cw 4 and pw 4
    # + the query's r + 2 ints 16 + two outputs 8
    assert _bytes.scan_nbytes(CFG, lines, f, le, plane, "out") == \
        64 + 4 + 4 + 16 + 8
    assert _bytes.scan_nbytes(CFG, lines, f, None, plane, "out") == \
        64 + 4 + 16 + 8


def test_roofline_share():
    assert _bytes.share(3.35e9, 1e-3) == 100.0
    assert _bytes.share(0, 1e-3) is None and _bytes.share(10, 0) is None
