"""repro_torch — the PyTorch/CUDA port of the LSketch package ``repro``.

Layers mirror the reference: ``core`` (config, state, hashing, dense
queries), ``engine`` (window ring, stacked insert), ``kernels`` (CUDA
kernels for Hopper with their plain PyTorch versions), ``sketch`` (spec,
handles, ingest, query), ``data`` (stream generators). Imports torch and
numpy only.
"""

__version__ = "0.1.0"
