"""Ranks of a mesh-resident sketch: one process per device under
``torch.distributed``.

The reference drives every device of a ``jax.sharding.Mesh`` from one
process. The port runs SPMD instead: rank ``r`` of ``W`` holds its block
of shard rows and runs the same program on the same inputs as every other
rank, and the collectives of ``torch.distributed`` stand where the
reference has ``lax.psum``, ``lax.pmax`` and ``lax.all_gather``
(``core/merge.py``, ``sketch/state.py``).

``init_group`` joins one rank to a group through a ``file://`` rendezvous
(no TCP port, so concurrent runs on one host cannot collide): NCCL for
ranks on the card, one card a rank, and gloo for ranks on the CPU, the
counterpart of the reference's fake host devices. ``spawn_ranks`` starts
``world`` such ranks with the ``spawn`` start method, runs ``fn(*args)``
in each once its group is up, and gives rank 0's return value back. A
rank that raises or dies fails the whole run: the others are stopped and
the error names that rank. The group's timeout bounds how long a
collective waits on a rank that will never arrive.
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile
import time
import traceback
from datetime import timedelta

import torch
import torch.distributed as dist

from repro_torch.core.types import resolve_device

GROUP_TIMEOUT_S = 300


def backend_for(device) -> str:
    """NCCL for a rank on the card, gloo for one on the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_group(rank: int, world: int, init_file, backend: str):
    """Join this process to a ``world``-rank group as ``rank`` through the
    rendezvous file ``init_file`` (which must not exist before the group's
    first rank starts); returns the default (world) group. A NCCL rank
    takes the card with its own index first."""
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(
        backend, init_method=f"file://{os.path.abspath(init_file)}",
        world_size=world, rank=rank,
        timeout=timedelta(seconds=GROUP_TIMEOUT_S))
    return dist.group.WORLD


def _rank_main(fn, rank, world, init_file, backend, args, results):
    torch.set_num_threads(1)
    try:
        init_group(rank, world, init_file, backend)
        out = fn(*args)
        results.put((rank, True, out if rank == 0 else None))
    except BaseException:
        # reported (synchronously) before the group goes down, so the
        # ranks that fail because this one left come later in the pipe
        results.put((rank, False, traceback.format_exc()))
        sys.exit(1)  # the parent reports the traceback
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(fn, world: int, *, device=None, args=(), init_file=None,
                backend: str | None = None):
    """Run ``fn(*args)`` on ``world`` spawned ranks of one group (NCCL for
    a CUDA ``device``, gloo for the CPU, or ``backend``: gloo ranks that
    share one card) and return rank 0's result. ``device``: the card
    unless the caller names the CPU (``core.types.resolve_device``).
    ``fn`` and ``args`` are pickled, so ``fn`` must be importable by its
    module path. ``init_file`` is the rendezvous file (default: one in a
    fresh temporary directory). Raises ``RuntimeError`` naming the first
    rank that failed, with its traceback."""
    backend = backend or backend_for(resolve_device(device))
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.SimpleQueue()
    tmp = None
    if init_file is None:
        tmp = tempfile.mkdtemp(prefix="ranks-")
        init_file = os.path.join(tmp, "rendezvous")
    procs = [ctx.Process(target=_rank_main, args=(
        fn, r, world, str(init_file), backend, tuple(args), results))
        for r in range(world)]
    got, failed = {}, None

    def drain() -> None:
        nonlocal failed
        while failed is None and not results.empty():
            rank, ok, payload = results.get()
            if ok:
                got[rank] = payload
            else:
                failed = f"rank {rank} of {world} failed:\n{payload}"

    try:
        for p in procs:
            p.start()
        while len(got) < world and failed is None:
            drain()
            if len(got) == world or failed is not None:
                break
            dead = [r for r, p in enumerate(procs)
                    if r not in got and p.exitcode not in (None, 0)]
            if dead:
                drain()  # its report may have landed since
                if failed is None:
                    failed = (f"rank {dead[0]} of {world} exited with code "
                              f"{procs[dead[0]].exitcode} and no report")
            else:
                time.sleep(0.05)
    finally:
        for p in procs:
            if p.pid is None:  # never started
                continue
            if failed is not None and p.is_alive():
                p.terminate()
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    if failed is not None:
        raise RuntimeError(failed)
    return got[0]
