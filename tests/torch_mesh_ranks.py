"""Rank processes for the port's mesh tests (``tests/test_torch_sharding.py``,
``test_torch_tp_decode.py``, ``test_torch_tp_engine.py``).

``spawn(job, ...)`` starts ``world`` processes with ``torch.multiprocessing``
on the CPU, joined by gloo through a file store under the test's temporary
directory (no port to collide on between test workers), one thread each.
Each rank runs the job's function and saves what it returns; ``spawn``
returns the results by rank. This module imports no JAX, and neither do
the ranks: the tests compare their results with JAX in the test process.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 4
# the mesh shapes of the tests, over 4 ranks
MESHES = {"2x2": dict(n_data=2, n_model=2),
          "dcn2x1x2": dict(n_dcn=2, n_data=1, n_model=2)}


def spawn(job: str, tmp_path, world: int = WORLD, **kw) -> list:
    """Run ``JOBS[job](**kw)`` on ``world`` gloo ranks; returns each rank's
    result, in rank order."""
    store = os.path.join(str(tmp_path), f"{job}_store")
    mp.spawn(_rank, args=(world, store, job, str(tmp_path), kw),
             nprocs=world, join=True)
    return [torch.load(os.path.join(str(tmp_path), f"{job}_{r}.pt"),
                       weights_only=False) for r in range(world)]


def _rank(rank: int, world: int, store: str, job: str, out_dir: str, kw):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        result = JOBS[job](rank, **kw)
        result["jax_imported"] = any(m == "jax" or m.startswith("jax.")
                                     for m in sys.modules)
        torch.save(result, os.path.join(out_dir, f"{job}_{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _meshes():
    from block_transformer_tpu_torch.parallel import sharding
    return {name: sharding.make_mesh(**kw, device="cpu")
            for name, kw in MESHES.items()}


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.numpy()


def mesh_job(rank, params_file, cfg):
    """Each mesh's names, shape and this rank's coordinate; this rank's
    shards of every tree under ``shard_params`` (the GSPMD rules) and, for
    tp = 2, ``shard_tp_params`` of ``prepare_tp_params``."""
    from block_transformer_tpu_torch.parallel import sharding, tp_decode
    trees = torch.load(params_file, weights_only=False)
    out = {}
    for name, mesh in _meshes().items():
        out[name] = {
            "names": tuple(mesh.mesh_dim_names), "shape": tuple(mesh.shape),
            "coord": tuple(mesh.get_coordinate()),
            "shards": {t: _np(sharding.shard_params(mesh, p))
                       for t, p in trees.items()},
            "tp_shards": {t: _np(tp_decode.shard_tp_params(
                mesh, tp_decode.prepare_tp_params(p, cfg, tp=2)))
                for t, p in trees.items()}}
    return out


def generate_job(rank, params_file, cfg, cases, ids, att, bam, max_blocks):
    """Greedy tokens of ``make_tp_generate_blocks`` for each case (mesh,
    tree, kv_cache, overlap_streams); then W8A8 forced at every M with the
    card's gate patched: how many W8A8 calls the TP generator and the
    single-device generator made; the top-1 pick on built ties; sampled
    decoding with two generators."""
    from block_transformer_tpu_torch.inference import generate as gen
    from block_transformer_tpu_torch.ops import linear as linear_ops
    from block_transformer_tpu_torch.parallel import tp_decode
    trees = torch.load(params_file, weights_only=False)
    meshes = _meshes()

    def generator(mesh, tree, kv, overlap=1, **kw):
        p = tp_decode.shard_tp_params(mesh, tp_decode.prepare_tp_params(
            trees[tree], cfg, tp=2))
        fn = tp_decode.make_tp_generate_blocks(
            mesh, cfg, p, max_blocks=max_blocks, kv_cache=kv,
            overlap_streams=overlap, **kw)
        return fn, p

    out = {"tokens": {}}
    for case in cases:
        fn, p = generator(meshes[case[0]], *case[1:])
        toks, nb = fn(p, ids, att, bam)
        out["tokens"][case] = (toks.numpy(), nb)

    # W8A8 at every M, the card's gate open: the TP programs take none
    calls = []
    real = linear_ops._w8a8_dot
    linear_ops._on_card = lambda x: True
    linear_ops._w8a8_dot = lambda *a: calls.append(1) or real(*a)
    with linear_ops.w8a8_min_m(1):
        fn, p = generator(meshes["2x2"], "int8", "int8")
        fn(p, ids, att, bam)
        out["w8a8_tp"] = len(calls)
        gen.generate_blocks(trees["int8"], cfg, ids, att, bam, max_blocks=6,
                            kv_cache="int8", device="cpu")
        out["w8a8_single"] = len(calls) - out["w8a8_tp"]

    # the top-1 pick over the vocab-sharded head on built ties (V = 8, 4 a
    # rank): rows whose maxima sit in both shards, in one, twice in one
    ax = tp_decode._axes(meshes["2x2"])
    logits = torch.tensor([[0., 3., 1., 0., 2., 3., 0., 0.],
                           [0., 1., 1., 0., 2., 3., 0., 3.],
                           [5., 0., 0., 5., 5., 0., 0., 0.],
                           [0., 0., 0., 0., 0., 0., 0., 0.]])
    lo = ax.model_index * 4
    head = {"embed_out": {"kernel": logits[:, lo:lo + 4].contiguous()}}
    eye = torch.eye(4)
    out["tie"] = tp_decode._tp_sample_tokens(
        head, eye, True, 1.0, tp_decode._Rng(None, None), ax=ax).numpy()
    out["tie_want"] = torch.argmax(logits, -1).to(torch.int32).numpy()

    # sampled: the same prompt in every row; two generators
    same = np.repeat(ids[:1], ids.shape[0], 0)
    fn, p = generator(meshes["2x2"], "fp32", "bf16", greedy=False,
                      temperature=1.0)
    out["sampled"] = [fn(p, same, att, bam,
                         torch.Generator().manual_seed(s))[0].numpy()
                      for s in (0, 1)]
    return out


def engine_job(rank, params_file, cfg, cases, prompts, budgets, kw):
    """Serve the same requests with the engine over each case's mesh
    (cases: (mesh, kv_cache, mesh_impl)); each request's tokens, the
    stats, and for a paged pool the free lists and page table after."""
    import dataclasses
    from block_transformer_tpu_torch.inference import engine as engine_lib
    trees = torch.load(params_file, weights_only=False)
    meshes = _meshes()
    out = {}
    for mesh_name, kind, impl in cases:
        eng = engine_lib.ContinuousBatchingEngine(
            trees["fp32"], cfg, device="cpu", kv_cache=kind,
            mesh=meshes[mesh_name], mesh_impl=impl, **kw[kind])
        for p, m in zip(prompts, budgets):
            eng.submit(p, m)
        reqs = list(eng.waiting)
        eng.run(max_steps=200)
        res = {"generated": [r.generated for r in reqs],
               "errors": [r.error for r in reqs],
               "stats": dataclasses.asdict(eng.stats),
               "has_work": eng.has_work()}
        if kind.startswith("paged"):
            res["free_pages"] = [sorted(f) for f in eng._free_pages]
            res["pages_per_shard"] = eng.pool_pages // eng._dp
            res["table_clear"] = not bool(eng.cache.page_table.any())
        out[(mesh_name, kind, impl)] = res
    return out


JOBS = {"mesh": mesh_job, "generate": generate_job, "engine": engine_job}
