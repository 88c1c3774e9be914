"""Rank bodies of ``tests/test_torch_sharded_serve.py``: the sharded
prefill and serve steps (``launch.step_fns.make_sharded_prefill_step``,
``make_sharded_serve_step``, ``shard_params``, ``shard_caches``), context
parallelism and ``DecodeServer(mesh=)`` on gloo ranks (no JAX here; the
ranks import this module by path). The test process draws every
parameter tree with ``repro`` and hands it over as numpy leaves, with
the seeded caches of the context-parallel cases."""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.launch import step_fns
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.launch.serve import DecodeServer, Request
from repro_torch.models import lm, transformer

B, PROMPT, CACHE, STEPS, FRAMES = 2, 12, 16, 3, 10
QWEN3 = "qwen3_8b"
ALL = ("deepseek_v2_236b", "kimi_k2_1t_a32b", QWEN3, "qwen15_110b",
       "smollm_135m", "gemma3_4b", "jamba_15_large_398b", "phi3_vision_42b",
       "seamless_m4t_medium", "xlstm_13b")
# prefill and decode: (arch, (data, model)) by world
CASES = {
    2: tuple((a, (1, 2)) for a in ALL),
    4: tuple((a, (2, 2)) for a in (QWEN3, "deepseek_v2_236b",
                                   "jamba_15_large_398b", "xlstm_13b",
                                   "seamless_m4t_medium"))
    + tuple((a, (1, 4)) for a in ("jamba_15_large_398b", "xlstm_13b",
                                  "kimi_k2_1t_a32b")),
}
# context parallelism: batch 1, the caches' sequence over "data"
CP_CASES = {2: (("gemma3_4b", (2, 1)), ("jamba_15_large_398b", (2, 1)),
                ("xlstm_13b", (2, 1))),
            4: (("gemma3_4b", (4, 1)),)}
CP_SEQ, CP_POS = 24, 14  # 3 steps from 14: Gemma-3's 8-slot rings wrap
SERVER_MESHES = {2: ((2, 1), (1, 2))}
SERVER = dict(batch_slots=4, max_seq=32, requests=6, prompt=5, max_new=4)


def config(arch: str):
    cfg = configs.get(arch, reduced=True)
    if cfg.n_experts:  # drop-free: a data shard's capacity aside
        cfg = cfg.replace(capacity_factor=cfg.n_experts / cfg.top_k)
    return cfg


def prompts(cfg, seed: int = 7) -> dict:
    """The prefill batch and the decode tokens ``[B, STEPS]``, numpy."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, PROMPT),
                                  dtype=np.int32),
           "decode": rng.integers(0, cfg.vocab_size, (B, STEPS),
                                  dtype=np.int32)}
    if cfg.frontend == "vision":
        out["prefix_emb"] = rng.standard_normal(
            (B, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    if cfg.is_encdec:
        out["frame_emb"] = rng.standard_normal(
            (B, FRAMES, cfg.d_model)).astype(np.float32)
    return out


def seeded_caches(cfg, seed: int = 11) -> list:
    """Caches of one sequence ``[1, CP_SEQ]`` filled from a seed, every
    attention layer's ``pos`` at CP_POS: what a long prompt left."""
    rng = np.random.default_rng(seed)
    out = []
    for spec in step_fns.cache_specs(cfg, 1, CP_SEQ):
        leaves = {}
        for name, (shape, dtype) in spec["mixer"].items():
            if name == "pos":
                leaves[name] = np.full(shape, CP_POS, np.int32)
            else:
                leaves[name] = rng.standard_normal(shape).astype(np.float32)
        out.append({"mixer": leaves})
    return out


def params_of(cfg, leaves: dict):
    return lm.params_from_leaves(
        cfg, {k: torch.from_numpy(np.array(v)) for k, v in leaves.items()})


def _rows_gathered(x, mesh, split: bool):
    """Every data rank's rows of ``x`` joined (as they are where the rows
    are not split)."""
    if not split or mesh.size(0) == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(mesh.size(0))]
    dist.all_gather(parts, x.contiguous(), group=mesh.get_group("data"))
    return torch.cat(parts)


def _full(caches) -> list:
    """Every cache leaf whole (a collective), numpy."""
    return [{"mixer": {k: v.full_tensor().numpy()
                       for k, v in c["mixer"].items()}} for c in caches]


def local_shapes(params, caches) -> dict:
    """This rank's shapes of every parameter shard and cache leaf."""
    out = {f"params.{k}": tuple(p.to_local().shape)
           for k, p in params.named_parameters()}
    out.update({f"caches.{i}.{k}": tuple(v.to_local().shape)
                for i, c in enumerate(caches)
                for k, v in c["mixer"].items()})
    return out


@contextlib.contextmanager
def mixer_rows():
    """While entered, notes each mixer call as (kind, shape of its
    ``w_out``): its rows are the channels it computes."""
    seen = []
    saved = dict(transformer._MIXERS)

    def wrap(kind, fn):
        def call(params, *args):
            seen.append((kind, tuple(params["w_out"].shape)))
            return fn(params, *args)
        return call

    for kind, entry in saved.items():
        transformer._MIXERS[kind] = (entry[0], wrap(kind, entry[1]),
                                     wrap(kind, entry[2]), *entry[3:])
    try:
        yield seen
    finally:
        transformer._MIXERS.update(saved)


def case(arch: str, mesh, leaves: dict) -> dict:
    """The sharded prefill of the prompt batch, then STEPS sharded decode
    steps from zeroed caches; every rank's rows gathered; the caches
    whole; rank 0's local shapes and mixer calls."""
    cfg = config(arch)
    n_data, row = mesh.size(0), mesh.get_coordinate()[0]
    params = step_fns.shard_params(cfg, params_of(cfg, leaves), mesh)
    data = prompts(cfg)
    batch = step_fns.local_rows(
        {k: torch.from_numpy(v) for k, v in data.items() if k != "decode"},
        1, n_data, row)
    with mixer_rows() as seen:
        logits = step_fns.make_sharded_prefill_step(cfg, mesh)(params, batch)
    prefill = _rows_gathered(logits, mesh, True)
    caches = step_fns.shard_caches(cfg, step_fns.cache_specs(cfg, B, CACHE),
                                   mesh)
    memory = None
    if cfg.is_encdec:
        memory = step_fns.sharded_encode_memory(cfg, mesh, params,
                                                batch["frame_emb"])
    step = step_fns.make_sharded_serve_step(cfg, mesh)
    toks = step_fns.local_rows({"t": torch.from_numpy(data["decode"])}, 1,
                               n_data, row)["t"]
    decode = []
    for i in range(STEPS):
        lg, caches = step(params, caches, toks[:, i:i + 1], memory)
        decode.append(_rows_gathered(lg, mesh, True).numpy())
    return dict(prefill=prefill.numpy(), decode=decode, caches=_full(caches),
                shapes=local_shapes(params, caches), mixers=seen)


def cp_case(arch: str, mesh, leaves: dict, caches_np: list) -> dict:
    """STEPS decode steps of one sequence from the seeded caches, the
    caches' sequence axis over "data"; the logits (the same on every
    rank) and the caches whole."""
    cfg = config(arch)
    params = step_fns.shard_params(cfg, params_of(cfg, leaves), mesh)
    caches = step_fns.shard_caches(cfg, [
        {"mixer": {k: torch.from_numpy(np.array(v))
                   for k, v in c["mixer"].items()}} for c in caches_np], mesh)
    toks = prompts(cfg)["decode"][:1]
    step = step_fns.make_sharded_serve_step(cfg, mesh)
    decode = []
    for i in range(STEPS):
        lg, caches = step(params, caches, torch.from_numpy(toks[:, i:i + 1]))
        decode.append(lg.numpy())
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, decode)
    return dict(decode=decode, caches=_full(caches),
                same_on_every_rank=all(
                    all(np.array_equal(a, b) for a, b in zip(r, decode))
                    for r in every),
                shapes=local_shapes(params, caches))


def server_requests(cfg) -> list:
    rng = np.random.default_rng(3)
    return [rng.integers(0, cfg.vocab_size, SERVER["prompt"]).tolist()
            for _ in range(SERVER["requests"])]


def server_case(mesh, leaves: dict) -> list:
    """``DecodeServer(mesh=)`` on the requests: every request's tokens."""
    cfg = config(QWEN3)
    params = step_fns.shard_params(cfg, params_of(cfg, leaves), mesh)
    server = DecodeServer(cfg, params, batch_slots=SERVER["batch_slots"],
                          max_seq=SERVER["max_seq"], device="cpu", mesh=mesh)
    reqs = [Request(prompt=p, max_new=SERVER["max_new"])
            for p in server_requests(cfg)]
    server.run(reqs)
    return [r.out for r in reqs]


def run(world: int, states: dict, cp_caches: dict) -> dict:
    """Every case of this world; rank 0's results."""
    torch.set_num_threads(1)
    meshes: dict = {}

    def mesh(shape):
        if shape not in meshes:
            meshes[shape] = make_smoke_mesh(*shape, device_type="cpu")
        return meshes[shape]

    out = {}
    for arch, shape in CASES[world]:
        out[(arch, shape)] = case(arch, mesh(shape), states[arch])
    for arch, shape in CP_CASES[world]:
        out[("cp", arch, shape)] = cp_case(arch, mesh(shape), states[arch],
                                           cp_caches[arch])
    for shape in SERVER_MESHES.get(world, ()):
        out[("server", shape)] = server_case(mesh(shape), states[QWEN3])
    return out
