"""Checkpoints without external dependencies (port of
``repro.distributed.checkpoint.CheckpointManager``; the on-disk format is
the reference's, so either package reads what the other wrote).

Layout, one directory a step::

    directory/step_00000100.tmp/   -> renamed to step_00000100/ to commit
        manifest.json              {"step", "keys", "extra", "time"}
        shard_0.npz                the leaves as arrays a0, a1, ...

A checkpoint is a flat, ordered mapping of leaf key strings to arrays; the
keys are the reference's key-path strings (a sharded sketch's are
``.shards/.<leaf>``). ``save`` copies every leaf to host memory before it
returns, so later in-place updates of the tensors cannot reach the
checkpoint, and with ``blocking=False`` writes on a thread. The rename
is the commit point; ``keep`` newest steps are retained.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np


def _host(x) -> np.ndarray:
    """A host copy of a tensor or array (never a view of its storage)."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy().copy()
    return np.array(x)


class CheckpointManager:
    def __init__(self, directory, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._pending: Optional[threading.Thread] = None

    def save(self, step: int, leaves: dict, extra: dict | None = None,
             blocking: bool = True) -> None:
        """Snapshot ``{key: tensor or array}`` to host memory now; write it
        in the background unless ``blocking``."""
        keys = list(leaves)
        host_vals = [_host(leaves[k]) for k in keys]
        meta = {"step": step, "keys": keys, "extra": extra or {},
                "time": time.time()}

        def write():
            tmp = self.dir / f"step_{step:08d}.tmp"
            final = self.dir / f"step_{step:08d}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            np.savez(tmp / "shard_0.npz",
                     **{f"a{i}": v for i, v in enumerate(host_vals)})
            (tmp / "manifest.json").write_text(json.dumps(meta))
            if final.exists():
                shutil.rmtree(final)
            os.rename(tmp, final)  # the commit
            self.gc()

        self.wait()  # one save in flight at a time
        if blocking:
            write()
        else:
            self._pending = threading.Thread(target=write, daemon=True)
            self._pending.start()

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _steps(self):
        return sorted((int(p.name.split("_")[1]), p)
                      for p in self.dir.iterdir()
                      if p.is_dir() and p.name.startswith("step_")
                      and not p.name.endswith(".tmp"))

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1][0] if steps else None

    def manifest(self, step: int | None = None) -> dict:
        """A saved step's manifest, without loading its arrays."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        return json.loads(
            (self.dir / f"step_{step:08d}" / "manifest.json").read_text())

    def restore(self, keys, step: int | None = None):
        """The arrays of a saved step in the order of ``keys``, which must
        be the saved keys; returns ``(arrays, extra)``."""
        meta = self.manifest(step)
        if list(keys) != meta["keys"]:
            raise ValueError(f"checkpoint keys {meta['keys']} != "
                             f"{list(keys)}")
        d = self.dir / f"step_{meta['step']:08d}"
        with np.load(d / "shard_0.npz") as data:
            vals = [data[f"a{i}"] for i in range(len(keys))]
        return vals, meta["extra"]

    def gc(self, keep: int | None = None) -> None:
        keep = self.keep if keep is None else keep
        for _, p in self._steps()[:-keep] if keep else []:
            shutil.rmtree(p, ignore_errors=True)
