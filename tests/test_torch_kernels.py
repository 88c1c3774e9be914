"""The plain versions of the port's three kernels against the JAX package's
hardware-kernel branches run in Pallas interpret mode (CPU, exact int32
equality). The CUDA kernels themselves are held against these plain
versions on the card by ``tests/test_torch_gpu.py``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import sketch as jskt
from repro.core import hashing as jh
from repro.core.lsketch import edge_probes as j_edge_probes
from repro.core.lsketch import precompute as j_precompute
from repro.core.queries import build_query_planes as j_build_planes
from repro.core.types import EdgeBatch as JBatch
from repro.core.types import LSketchConfig as JConfig
from repro.core.types import init_state as j_init_state
from repro.kernels.sketch_insert.ops import \
    matrix_insert_binned_sharded as j_insert
from repro.kernels.sketch_query.ops import edge_query_planes as j_edge_planes
from repro.kernels.vertex_scan.kernel import vertex_scan_xla
from repro.kernels.vertex_scan.ops import \
    vertex_query_planes as j_vertex_planes
from repro.sketch.query import _with_global_window as j_global_window

from repro_torch.core import hashing as th
from repro_torch.core.lsketch import edge_probes, precompute
from repro_torch.core.queries import QueryPlanes
from repro_torch.core.types import LSketchConfig, init_leaves
from repro_torch.kernels.sketch_insert.kernel import \
    sketch_insert_kernel_sharded
from repro_torch.kernels.sketch_insert.ops import \
    matrix_insert_binned_sharded
from repro_torch.kernels.sketch_query.kernel import \
    sketch_query_kernel_sharded
from repro_torch.kernels.sketch_query.ops import edge_query_planes
from repro_torch.kernels.vertex_scan.kernel import (
    vertex_scan_kernel_sharded, vertex_scan_plain)
from repro_torch.kernels.vertex_scan.ops import vertex_query_planes

KW = dict(d=32, n_blocks=2, F=256, r=4, s=4, c=4, k=4, window_size=100,
          pool_capacity=32, pool_probes=4)
JCFG, TCFG = JConfig(**KW), LSketchConfig(**KW)


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int32))


def _eq(j, t):
    np.testing.assert_array_equal(np.asarray(j).astype(np.int64),
                                  t.numpy().astype(np.int64))


def _probes(rng, S, B, nv):
    src = rng.integers(0, nv, (S, B)).astype(np.int32)
    dst = rng.integers(0, nv, (S, B)).astype(np.int32)
    jp = j_edge_probes(JCFG, j_precompute(JCFG, jnp.asarray(src),
                                          jnp.asarray(src % 3)),
                       j_precompute(JCFG, jnp.asarray(dst),
                                    jnp.asarray(dst % 3)))
    tp = edge_probes(TCFG, precompute(TCFG, _t(src), _t(src % 3)),
                     precompute(TCFG, _t(dst), _t(dst % 3)))
    return jp, tp


@pytest.mark.parametrize("S,B,nv,max_bin,seed", [
    (2, 96, 50, 96, 0),   # no cap
    (2, 96, 50, 4, 1),    # a biting max_bin: bin overflow goes to the pool
    (3, 64, 400, 64, 2),  # sparse keys, zero weights included
])
def test_insert_plain_matches_jax_kernel_interpret(S, B, nv, max_bin, seed):
    rng = np.random.default_rng(seed)
    jp, tp = _probes(rng, S, B, nv)
    le = rng.integers(0, 5, (S, B)).astype(np.int32)
    w = rng.integers(0, 3, (S, B)).astype(np.int32)
    slot = rng.integers(0, KW["k"], S).astype(np.int32)
    jle = jh.edge_label_bucket(jnp.asarray(le), JCFG.c, JCFG.seed)
    base = jax.tree.map(lambda x: jnp.stack([x] * S), j_init_state(JCFG))
    run = functools.partial(j_insert, JCFG)
    ref = jax.jit(lambda st: run(st, jp, jle, jnp.asarray(w),
                                 jnp.asarray(slot), max_bin=max_bin,
                                 interpret=False, _kernel_interpret=True)
                  )(base)
    st = init_leaves(TCFG, (S,), "cpu")
    tle = th.edge_label_bucket(_t(le), TCFG.c, TCFG.seed)
    matrix_insert_binned_sharded(TCFG, st, tp, tle, _t(w), _t(slot),
                                 max_bin=max_bin)
    for a, b in zip(jax.tree.leaves(ref), st.leaves()):
        _eq(a, b)
    if max_bin < B:
        assert int(jnp.sum(ref.pool_key[..., 0] != -1)) > 0


def _jax_planes(S, seed):
    """A JAX-built state with wraparound and pool overflow, its window-
    reduced planes (as the JAX query path builds them) and the port's
    copy of those planes."""
    rng = np.random.default_rng(seed)
    spec = jskt.SketchSpec(kind="lsketch", config=JCFG, n_shards=S)
    state = jskt.create(spec)
    for t in (10, 60, 120, 180):
        n = 150
        state = jskt.ingest(spec, state, JBatch(
            *[jnp.asarray(x, jnp.int32) for x in (
                rng.integers(0, 60, n), rng.integers(0, 60, n),
                rng.integers(0, 3, n), rng.integers(0, 3, n),
                rng.integers(0, 6, n), rng.integers(1, 4, n),
                np.full(n, t))]))
    planes = jax.jit(lambda sh: j_build_planes(JCFG, sh, None))(
        j_global_window(state.shards))
    tplanes = QueryPlanes(*[_t(x) for x in (
        planes.key, planes.cw, planes.pw, planes.pool_key, planes.pool_cw,
        planes.pool_pw)])
    return planes, tplanes, rng


@pytest.mark.parametrize("S", [1, 3])
def test_query_plain_matches_jax_kernel_interpret(S):
    planes, tplanes, rng = _jax_planes(S, S)
    nq = 100
    qs, qd = rng.integers(0, 60, nq), rng.integers(0, 60, nq)
    le = rng.integers(0, 6, nq)
    jl = tuple(jnp.asarray(x, jnp.int32) for x in (qs % 3, qd % 3, le))
    tl = tuple(_t(x) for x in (qs % 3, qd % 3, le))
    for with_le in (False, True):
        ref = jax.jit(lambda p: j_edge_planes(
            JCFG, p, jnp.asarray(qs, jnp.int32), jnp.asarray(qd, jnp.int32),
            jl, with_le=with_le, interpret=False, _kernel_interpret=True))(
                planes)
        got = edge_query_planes(TCFG, tplanes, _t(qs), _t(qd), tl,
                                with_le=with_le)
        for a, b in zip(ref, got):
            _eq(a, b)

    vq = np.arange(40, dtype=np.int32)
    vle = rng.integers(0, 6, 40)
    for direction in ("out", "in"):
        for with_le in (False, True):
            ref = jax.jit(lambda p: j_vertex_planes(
                JCFG, p, jnp.asarray(vq), (jnp.asarray(vq % 3),
                                           jnp.asarray(vle, jnp.int32)),
                direction=direction, with_le=with_le, interpret=False,
                _kernel_interpret=True))(planes)
            got = vertex_query_planes(TCFG, tplanes, _t(vq),
                                      (_t(vq % 3), _t(vle)),
                                      direction=direction, with_le=with_le)
            for a, b in zip(ref, got):
                _eq(a, b)


def test_vertex_scan_plain_decodes_negative_keys_like_jax():
    """Keys other than EMPTY that are negative never occur in a real
    sketch, but the decode must still follow jnp's floor semantics."""
    rng = np.random.default_rng(9)
    S, d, c, nq, r, F = 2, 16, 3, 12, 4, 8
    key = rng.integers(-3000, 3000, (S, 2, d, d)).astype(np.int32)
    key[key % 7 == 0] = -1
    cw = rng.integers(0, 9, (S, 2, d, d)).astype(np.int32)
    pw = rng.integers(0, 9, (S, 2, d, d, c)).astype(np.int32)
    lines = rng.integers(0, d, (nq, r)).astype(np.int32)
    f = rng.integers(0, F, nq).astype(np.int32)
    le = rng.integers(0, c, nq).astype(np.int32)
    for direction in ("out", "in"):
        ref = vertex_scan_xla(*map(jnp.asarray, (lines, f, le, key, cw, pw)),
                              r=r, F=F, direction=direction)
        got = vertex_scan_plain(*map(_t, (lines, f, le, key, cw, pw)), r=r,
                                F=F, direction=direction)
        for a, b in zip(ref, got):
            _eq(a, b)


def test_wrappers_take_plain_version_only_on_cpu():
    """On a CPU tensor each wrapper computes its plain version and counts
    no launch."""
    planes, tplanes, rng = _jax_planes(1, 5)
    before = (sketch_query_kernel_sharded.launches,
              vertex_scan_kernel_sharded.launches,
              sketch_insert_kernel_sharded.launches)
    edge_query_planes(TCFG, tplanes, _t([1, 2]), _t([3, 4]),
                      (_t([0, 1]), _t([1, 2]), _t([0, 0])))
    vertex_query_planes(TCFG, tplanes, _t([1, 2]), (_t([0, 1]), _t([0, 0])))
    assert (sketch_query_kernel_sharded.launches,
            vertex_scan_kernel_sharded.launches,
            sketch_insert_kernel_sharded.launches) == before
