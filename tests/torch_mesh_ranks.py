"""Rank processes for the port's mesh tests (``tests/test_torch_sharding.py``,
``test_torch_tp_decode.py``, ``test_torch_tp_engine.py``,
``test_torch_sharded_train.py``, ``test_torch_pipeline.py``).

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
# the training meshes: make_mesh's, and (data, pipe) meshes by axis names
TRAIN_MESHES = {**MESHES, "1x2x2seq": dict(n_data=1, n_seq=2, n_model=2),
                "2x2pipe": ((2, 2), ("data", "pipe")),
                "1x4pipe": ((1, 4), ("data", "pipe"))}


def spawn(job: str, tmp_path, world: int = WORLD, **kw) -> list:
    """Run ``JOBS[job](**kw)`` on ``world`` gloo ranks; returns each rank's
    result, in rank order."""
    return spawn_async(job, tmp_path, world, **kw)()


def spawn_async(job: str, tmp_path, world: int = WORLD, **kw):
    """Start ``spawn``'s ranks and return at once a function that waits for
    them and returns their results (the test process computes JAX's side
    meanwhile)."""
    store = os.path.join(str(tmp_path), f"{job}_store")
    ctx = mp.spawn(_rank, args=(world, store, job, str(tmp_path), kw),
                   nprocs=world, join=False)

    def wait() -> list:
        while not ctx.join():
            pass
        return [torch.load(os.path.join(str(tmp_path), f"{job}_{r}.pt"),
                           weights_only=False) for r in range(world)]

    return wait


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


def _train_mesh(name):
    from block_transformer_tpu_torch.parallel import sharding
    kw = TRAIN_MESHES[name]
    if isinstance(kw, tuple):
        return sharding.named_mesh(*kw, device="cpu")
    return sharding.make_mesh(**kw, device="cpu")


def _full(ts, mesh, tree, specs, layout):
    from block_transformer_tpu_torch.train import optimizer as opt
    return {p: ts._unplace(layout, p, t, dict(opt.tree_items(specs))[p]
                           ).numpy().copy()
            for p, t in opt.tree_items(tree)}


def train_job(rank, state_file, cfg, cases, batches, tkw):
    """For each case (mesh name, n_micro or None): two steps from the
    bridged full state on the batches (the global ones, every rank the
    same), by ``make_sharded_grad_and_apply`` (``make_pp_train_step`` when
    n_micro is given). Per step: the metrics, the global gradient (reduced
    and gathered, JAX's layout; for the pipeline, whose step applies at
    once, that of the first batch at the initial state), the gathered
    parameters and moments, the grad norm; the first
    two steps again by ``make_sharded_train_step`` (step 1's loss and
    norm, the parameters after step 2); the bytes
    of each moment leaf on this rank against the full leaf's."""
    from block_transformer_tpu_torch.parallel import collectives
    from block_transformer_tpu_torch.parallel import pipeline
    from block_transformer_tpu_torch.parallel import sharding
    from block_transformer_tpu_torch.train import optimizer as opt
    from block_transformer_tpu_torch.train import train_step as ts
    state = torch.load(state_file, weights_only=False)
    tx, _ = opt.make_optimizer(**tkw)
    out = {}
    for name, n_micro in cases:
        mesh = _train_mesh(name)
        if n_micro:
            step, spec = pipeline.make_pp_train_step(
                mesh, cfg, tx, state.params, n_micro=n_micro, remat=True)
            res = {"pspecs": spec.params, "mspecs": spec.opt_state.mu}
        else:
            spec = ts._state_spec(mesh, state.params)
            grad_fn, apply_fn, zeros_fn = ts.make_sharded_grad_and_apply(
                mesh, cfg, tx, state.params, remat=True)
            res = {"mspecs": spec.opt_state.mu}
        layout = ts._layout(mesh, spec)
        local = ts.shard_with(mesh, _clone(state), spec)
        if n_micro:
            # the pipelined loss's gradient at the initial state, reduced
            # and gathered, as the step computes it
            loss_fn = ts._mesh_loss_fn(
                mesh, cfg, True,
                pipeline.make_pp_block_decoder_forward(mesh, n_micro),
                pipeline.make_pp_token_decoder_stack(mesh, cfg.token_decoder,
                                                     n_micro, remat=True))
            g, _ = ts._grads(loss_fn, local.params, ts._local_batch(
                mesh, batches[0], sharding.batch_pspec(mesh)),
                1.0 / collectives.axis(mesh, "pipe").size)
            ts._reduce_grads(layout, g)
            res["grads"] = _full(ts, mesh, opt.tree_unflatten(g),
                                 spec.params, layout)
        res["moment_bytes"] = {
            p: (t.numel() * t.element_size(),
                full.numel() * full.element_size())
            for (p, t), full in zip(opt.tree_items(local.opt_state.mu),
                                    opt.tree_leaves(state.opt_state.mu))}
        res["steps"] = []
        for batch in batches:
            rec = {}
            if n_micro:
                local, metrics = step(local, batch)
                rec["grad_norm"] = float(metrics["grad_norm"])
            else:
                acc, metrics = grad_fn(local.params, batch,
                                       zeros_fn(local.params))
                g = {p: t.clone() for p, t in opt.tree_items(acc)}
                ts._reduce_grads(layout, g)
                rec["grads"] = _full(ts, mesh, opt.tree_unflatten(g),
                                     spec.params, layout)
                local, norm = apply_fn(local, acc, 1.0)
                rec["grad_norm"] = float(norm)
            rec["metrics"] = {k: v.numpy() for k, v in metrics.items()
                              if k != "grad_norm"}
            full = ts.gather_state(mesh, local, spec)
            rec["params"] = {p: t.numpy().copy()
                             for p, t in opt.tree_items(full.params)}
            rec["mu"] = {p: t.numpy().copy()
                         for p, t in opt.tree_items(full.opt_state.mu)}
            rec["nu"] = {p: t.numpy().copy()
                         for p, t in opt.tree_items(full.opt_state.nu)}
            res["steps"].append(rec)
        if not n_micro:
            one = ts.make_sharded_train_step(mesh, cfg, tx, state.params,
                                             remat=False)
            s1, m1 = one(ts.shard_state(mesh, tx, _clone(state)), batches[0])
            s1, _ = one(s1, batches[1])
            full = ts.gather_state(mesh, s1, spec)
            res["train_step"] = {"loss": float(m1["loss"]),
                                 "grad_norm": float(m1["grad_norm"]),
                                 "params": {p: t.numpy() for p, t in
                                            opt.tree_items(full.params)}}
        out[name] = res
    return out


def _clone(state):
    from block_transformer_tpu_torch.train import optimizer as opt
    c = lambda t: t.clone()                              # noqa: E731
    o = state.opt_state
    return type(state)(opt.tree_map(c, state.params), type(o)(
        o.count, opt.tree_map(c, o.mu), opt.tree_map(c, o.nu)), state.step)


def trainer_job(rank, cfg, vcfg, tkw, out_dir, data):
    """The port's ``Trainer`` and ``VanillaTrainer`` over (data 2, model 2)
    from the bridged JAX initial states; returns rank 0's metrics records
    of each, every rank's final step, whether its last checkpoint restores
    into the rank's shards bit for bit, and the devices of the host
    gather's leaves (None on the ranks that drop them)."""
    import json
    from block_transformer_tpu_torch.data import packing
    from block_transformer_tpu_torch.train import optimizer as opt
    from block_transformer_tpu_torch.train import trainer
    from block_transformer_tpu_torch.train import train_step as ts
    from block_transformer_tpu_torch.train import vanilla_trainer
    corpus, ds_kw, state_file, vstate_file = data
    out = {}
    for name, make, model_cfg, kw, sfile in (
            ("block", trainer.Trainer, cfg, ds_kw, state_file),
            ("vanilla", vanilla_trainer.VanillaTrainer, vcfg,
             dict(eos_token=0, block_length=None), vstate_file)):
        ds = packing.PackedDataset(corpus, tkw["max_length"], **kw)
        d = os.path.join(out_dir, name)
        tt = make(model_cfg, trainer.TrainerConfig(output_dir=d, **tkw), ds,
                  device="cpu")
        tt.state = ts.shard_state(tt.mesh, tt.tx, torch.load(
            sfile, weights_only=False))
        tt.train()
        recs = []
        if rank == 0:
            with open(os.path.join(d, "metrics.jsonl")) as f:
                recs = [json.loads(line) for line in f]
        # the last checkpoint cut back into this rank's shards, against
        # the shards it trained; the host gather keeps the state on rank 0
        back = tt.mesh_state.restore(d, tt.state.step, tt.state)
        host = ts.gather_state(tt.mesh, tt.state, tt.mesh_state.spec,
                               to_host=True)
        out[name] = {"records": recs, "step": tt.state.step,
                     "restored_equal": _equal_states(back, tt.state),
                     "host_gather": None if host is None else sorted(
                         {str(t.device) for t in
                          opt.tree_leaves(host.params)})}
    return out


def _equal_states(a, b) -> bool:
    from block_transformer_tpu_torch.train import optimizer as opt
    pairs = [(a.params, b.params), (a.opt_state.mu, b.opt_state.mu),
             (a.opt_state.nu, b.opt_state.nu)]
    return (a.step == b.step and a.opt_state.count == b.opt_state.count
            and all(x[0] == y[0] and x[1].dtype == y[1].dtype
                    and torch.equal(x[1], y[1])
                    for ta, tb in pairs for x, y in zip(
                        opt.tree_items(ta), opt.tree_items(tb))))


JOBS = {"mesh": mesh_job, "generate": generate_job, "engine": engine_job,
        "train": train_job, "trainer": trainer_job}
