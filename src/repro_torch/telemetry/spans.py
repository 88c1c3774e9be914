"""Named ranges of the program's stages, for the profiler.

``span(name)`` is the port's one way to mark a range. While a
``torch.profiler`` profile runs, it returns
``torch.profiler.record_function(name)``: the profiler keeps the range in
memory with its start and end on the clock of the device's operations,
and ranges opened on one thread nest, so each has the range it was opened
in as its parent. With no profiler running it returns one shared no-op
context, so a range costs one flag check.

The ranges are named ``lsketch.<stage>``:

  * the engine's stages (``engine/insert.py``,
    ``kernels/sketch_insert/ops.py``): ``window_plan``, ``addressing``,
    ``bin_plan``, ``insert_kernel``, ``pool_pass``, ``scan_insert``,
    ``planes_delta``;
  * the ingest (``sketch/ingest.py``): ``ingest.partition``, the host
    partition of a batch, and ``ingest.dispatch``, its stacked insert
    (the staging copy, the engine's stages and the delta's hand-over);
  * the plane cache (``sketch/query.py``): ``planes.resolve``, the
    check of a pending delta chain and its device read,
    ``planes.fold``, one link folded, ``planes.build``, one build;
  * a query (``sketch/query.py``: ``query``, and each pass of
    ``query_many``): ``query.prepare``, the padded batch on the device
    and the plane lookup, and ``query.answer``, the launches;
  * the server (``launch/serve_sketch.py::SketchServer``):
    ``server.ingest`` and ``server.flush``, each call, ``server.prewarm``,
    each warming of the plane cache, ``server.group``, one dispatch pass
    of a flush (a single handle's: one a query kind present; a pool's:
    one a request group), and ``server.readback``, answers read to the
    host (a single handle's: once a flush, directly under
    ``server.flush``; a pool's: once a group). So ``server.group``
    ranges over ``server.flush`` ranges count the dispatch passes a
    flush.

A range that waits on the device (a ``.cpu()``, a ``bool`` of a device
tensor) holds that wait in its duration.
"""

from __future__ import annotations

import contextlib

import torch
from torch.profiler import record_function

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context marking ``name`` on the running profiler's timeline; a
    no-op when none runs."""
    if torch.autograd._profiler_enabled():
        return record_function(name)
    return _OFF
