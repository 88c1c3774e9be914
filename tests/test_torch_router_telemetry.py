"""The port's router telemetry (``repro_torch.telemetry.RouterTelemetry``,
``CapacityController``) against ``repro.telemetry`` on the CPU, exactly.

The four cases of ``tests/test_telemetry.py`` (load tracking, window
expiry, the sharded sketch against a single one, the controller's
reaction), run on both packages with the same seeded counts
(``tests/torch_collective_ranks.py::telemetry_cases``): at 1 and 4 shards
on the port's "scan" and "cuda" paths against the reference's "scan" and
"pallas", and with ``mesh=`` over 2 gloo ranks, where a dividing layout
reads through ``"collective"``. The checkpoint of a telemetry sketch
restores in ``repro``. The MoE layer that emits the counts
(``test_moe_emits_telemetry_counts``) is not ported yet.
"""

import numpy as np
import pytest

from repro import sketch as jskt
from repro import telemetry as jtele

from repro_torch import sketch as tskt
from repro_torch import telemetry as ttele
from repro_torch.distributed.ranks import spawn_ranks

import torch_collective_ranks as R

CPU = "cpu"


def _same(a, b, where=()):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _same(a[k], b[k], where + (k,))
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, where + (i,))
    else:
        assert np.array_equal(np.asarray(a), np.asarray(b)), (where, a, b)


_REF: dict = {}


def _ref(ns):
    """``repro``'s reads at ``ns`` shards on its "scan" and "pallas"
    paths."""
    if ns not in _REF:
        _REF[ns] = R.telemetry_cases(jtele, ("scan", "pallas"), n_shards=ns)
    return _REF[ns]


def _reference_assertions(r):
    """The assertions of ``tests/test_telemetry.py`` on one path's
    reads."""
    loads, recent, imb, _ = r["tracks"]
    assert int(np.argmax(loads)) == 3 and imb > 1.5
    assert r["expires"][0] == 0 and r["expires"][1] <= 5 * 256
    _same(r["sharded"][0], r["sharded"][1])
    assert r["controller"][0] > 1.25 and r["controller"][1] < 2.0


@pytest.mark.parametrize("ns", [1, 4])
def test_router_telemetry_matches_repro(ns):
    """At ``ns`` shards the port's "scan" reads equal the reference's
    "scan" reads and its "cuda" reads its "pallas" reads."""
    got = R.telemetry_cases(ttele, ("scan", "cuda"), n_shards=ns,
                            device=CPU)
    want = _ref(ns)
    assert got["default"] == "auto" and want["default"] == "auto"
    _same(got["scan"], want["scan"])
    _same(got["cuda"], want["pallas"])
    _reference_assertions(got["cuda"])


def test_router_telemetry_mesh_matches_repro(tmp_path):
    """``mesh=`` over 2 gloo ranks: 4 shards divide the group, so the
    telemetry reads through "collective" by default, and rank 0's reads on
    every path equal ``repro``'s at 4 shards."""
    got = spawn_ranks(R.telemetry_mesh, 2, device=CPU, args=(4,),
                      init_file=tmp_path / "rdv")
    assert got["default"] == "collective"
    want = _ref(4)
    for p in ("collective", "scan", "cuda"):
        _same(got[p], want["scan"])
    _reference_assertions(got["collective"])


def test_router_telemetry_checkpoint_restores_in_repro(tmp_path):
    tele = ttele.RouterTelemetry(n_experts=8, window_steps=16, subwindows=4,
                                 n_shards=4, device=CPU)
    rng = np.random.default_rng(2)
    for step in (0, 4, 8):
        tele.ingest(rng.integers(0, 4, (256, 8)), step)
    tele.checkpoint(tmp_path, step=8)
    jt = jtele.RouterTelemetry(n_experts=8, window_steps=16, subwindows=4,
                               n_shards=4)
    back = jskt.restore(jt.spec, tmp_path)
    for x, y in zip(tskt.to_numpy(tele.state),
                    [np.asarray(v) for v in
                     __import__("jax").tree.leaves(back.shards)]):
        assert np.array_equal(x, y)
    assert tele.query_path == "auto"
