"""Elasticity and crash-only training of the port
(``repro_torch.distributed.elastic``, ``RestartLoop`` around
``launch.train``) on gloo ranks of the CPU.

A train state saved under mesh (2, 1) (``elastic.remesh``'s first
segment, 2 ranks) restores under (2, 2) and under (1, 1): restored and
saved again with no step between, every leaf equals the saved one, bit
for bit (the counterpart of ``tests/test_multidevice.py:78`` and
``tests/test_checkpoint_ft.py:116``); training continued at each mesh
holds the losses of an unbroken single-device run within REL, the
tolerance ``tests/test_torch_sharded_train.py`` holds the sharded step's
loss to. Worlds 2, 4 and 1 are each spawned once (rank bodies
``tests/torch_elastic_ranks.py``). At world 1 a run that crashes once
under ``RestartLoop`` ends with an unbroken run's losses, bit for bit,
and ``chip_smoke``'s L11 rehearses on the CPU."""

import functools
import shutil
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.distributed.checkpoint import CheckpointManager
from repro_torch.distributed.elastic import (ElasticEvent, make_elastic_mesh,
                                             plan_mesh, remesh,
                                             resharding_specs)
from repro_torch.distributed.ranks import spawn_ranks
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.launch.step_fns import state_placements
from repro_torch.launch.train import train
from repro_torch.optim import AdamWConfig

import torch_elastic_ranks as R

REL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def pinned():
    """One torch thread while the file runs: many small ops, beside the
    suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The (2, 1) segment's checkpoint, the (2, 2) and (1, 1) segments
    after it, and the unbroken single-device run."""
    tmp = tmp_path_factory.mktemp("elastic")
    first = remesh(ElasticEvent("steady", 2, (2, 1)), tmp / "a",
                   steps=R.SPLIT, device="cpu", **R.RESUME)
    for d in ("grown", "shrunk"):
        shutil.copytree(tmp / "a", tmp / d)
    kw = dict(R.RESUME, device="cpu")
    with ThreadPoolExecutor(max_workers=2) as pool:
        futs = {d: pool.submit(spawn_ranks, R.restore_then_continue, n_r,
                               device="cpu", args=(shape, dict(
                                   kw, ckpt_dir=str(tmp / d))))
                for d, n_r, shape in (("grown", 4, (2, 2)),
                                      ("shrunk", 1, (1, 1)))}
        unbroken = train(**R.RESUME, steps=R.STEPS, smoke=True,
                         ckpt_dir=str(tmp / "unbroken"), device="cpu")
        out = {d: f.result() for d, f in futs.items()}
    return dict(out, first=first, unbroken=unbroken, dir=tmp)


def _checkpoint(d: Path, step: int):
    mgr = CheckpointManager(d)
    keys = mgr.manifest(step)["keys"]
    arrays, extra = mgr.restore(keys, step)
    return dict(zip(keys, arrays)), extra


@pytest.mark.parametrize("where", ["grown", "shrunk"])
def test_a_state_saved_at_one_mesh_restores_at_another(runs, where):
    saved, extra = _checkpoint(runs["dir"] / "a", R.SPLIT)
    again, extra_again = _checkpoint(runs["dir"] / where, R.SPLIT)
    assert extra_again == extra
    assert list(again) == list(saved)
    for k, v in saved.items():
        assert again[k].dtype == v.dtype and np.array_equal(again[k], v), k


@pytest.mark.parametrize("where", ["first", "grown", "shrunk"])
def test_training_goes_on_after_each_remesh(runs, where):
    want = runs["unbroken"]
    got = runs[where]
    want = want[:R.SPLIT] if where == "first" else want[R.SPLIT:]
    assert len(got) == len(want)
    np.testing.assert_allclose(got, want, rtol=REL)


def test_elastic_mesh_and_specs():
    """``make_elastic_mesh`` without a group is ``plan_mesh``'s shape;
    ``resharding_specs`` are the train state's placements on the new
    mesh."""
    mesh = make_elastic_mesh(1, "cpu")
    assert mesh.axis_sizes == plan_mesh(1) == (1, 1)
    cfg = configs.get("smollm_135m", reduced=True)
    opt = AdamWConfig()
    big = AbstractMesh(plan_mesh(512), ("data", "model"))
    assert resharding_specs(cfg, opt, big) == state_placements(cfg, opt, big)
    with pytest.raises(ValueError, match="mesh"):
        remesh(ElasticEvent("grow", 4, (2, 1)), "unused", steps=1,
               device="cpu")


def _chip_smoke(monkeypatch):
    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    for name, value in (("LM_REDUCED", True), ("TRAIN_BATCH", 2),
                        ("TRAIN_SEQ", 32), ("TRAIN_MICROBATCHES", 2)):
        monkeypatch.setattr(chip_smoke, name, value)
    return chip_smoke


def test_a_crashed_run_ends_with_the_unbroken_losses(monkeypatch, tmp_path):
    """World 1: 6 steps with a checkpoint every 3 and a fault after step
    4 under ``RestartLoop``: one restart from the checkpoint of step 4
    (4 steps done), the last step 6, the losses an unbroken run's bit for
    bit."""
    cs = _chip_smoke(monkeypatch)
    kw = dict(arch="smollm_135m", steps=6, smoke=True, batch_size=2,
              seq_len=32, microbatches=2, log_every=100, seed=0,
              lr_peak=1e-3, device="cpu")
    unbroken = train(**kw, ckpt_dir=str(tmp_path / "u"), ckpt_every=0)
    run = cs.restart_run(kw, str(tmp_path / "c"), fault_after=4,
                         ckpt_every=3)
    assert run["final_step"] == 6 and run["restarts"] == 1
    assert run["starts"] == [0, 4]
    assert [len(s) for s in run["segment_losses"]] == [5, 2]
    assert run["losses"] == unbroken
    assert run["segment_losses"][0][4] == run["segment_losses"][1][0]
    assert CheckpointManager(tmp_path / "c").latest_step() == 6
    # a checkpoint's label is the updates in its state: the periodic one
    # of step 3 (4 steps done) and the final one
    for label in (4, 6):
        leaves, extra = _checkpoint(tmp_path / "c", label)
        assert extra["step"] == label == int(leaves["step"])


def test_a_failed_drain_does_not_hide_the_fault(monkeypatch, tmp_path):
    """A fault that leaves ``train`` while the checkpoint drain raises too
    is still the fault, with the drain's error as a note."""
    cs = _chip_smoke(monkeypatch)
    with cs.inject_fault(0) as log:
        def wait(self):
            if log["fault_t"] is not None:
                raise OSError("the drain's error")
        monkeypatch.setattr(CheckpointManager, "wait", wait)
        with pytest.raises(cs.InjectedFault) as info:
            train(arch="smollm_135m", steps=3, smoke=True, batch_size=2,
                  seq_len=32, log_every=100, ckpt_every=0,
                  ckpt_dir=str(tmp_path), device="cpu")
    assert any("the drain's error" in n for n in info.value.__notes__)


def test_chip_smoke_restart_phase_rehearses_on_the_cpu(monkeypatch, capsys):
    """``chip_smoke``'s L11 at the reduced config: every comparison holds;
    the launch check only the card can pass fails here."""
    cs = _chip_smoke(monkeypatch)
    # the step times of a loaded CPU are noise: no ratio flags a host here
    # (the straggler rule is held to the reference's in
    # tests/test_torch_fault_tolerance.py)
    monkeypatch.setattr(cs, "StragglerPolicy", functools.partial(
        cs.StragglerPolicy, ratio=1e9))
    dev = torch.device("cpu")
    out = cs.restart_phase(dev, "[cpu]", {"step_s": [1.0] * 21})
    assert out["losses_equal"] and out["restarted_step_equal"]
    assert out["restart_s"] > 0 and out["health"]["dead"] == []
    with pytest.raises(AssertionError, match="L11: flash launches"):
        cs.check_restart_on_the_card(
            configs.get(cs.TRAIN_ARCH, reduced=True), out)
    assert "L11 crash and restore" in capsys.readouterr().out
