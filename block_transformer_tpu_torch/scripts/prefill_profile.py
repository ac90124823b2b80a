"""Prefill decomposition: where do the b256 p2048 prefill seconds go? (port
of ``scripts/prefill_profile.py``)

``block_main_b4_1.2b`` at random weights (``--quantize`` INT8 by default),
``--batch`` 256 prompts of ``--prefill`` 2048 tokens, the block decoder's
``--kv`` cache INT8 by default. Stages timed separately, each after one
untimed call, by CUDA events (device s) and the host clock between
synchronizations (wall s):

  1. embedder               ``embed_blocks`` at [B, N, L]
  2. block prefill (full)   the chunked ``_block_decoder_step`` loop of the
                            streaming prefill (the cache's quantize and
                            write included), chunks of ``--chunk_blocks``
  2c. (chunked)             the same inside ``ops.attention.
                            chunked_prefill_attention()`` (the JAX script's
                            ``BT_CHUNKED_PREFILL_ATTN=1``)
  2d. (fresh)               ``neox_prefill_fresh`` with the config's
                            attention
  2e. (fresh+flash)         the same with ``attn_impl="pallas"``: K3
  2b. (bf16 KV)             the full block prefill over a bf16 cache
                            (~16 GB at b256: it runs on an 80 GB card)
  3. matmul floor           the same 12-layer QKV/O/up/down chain at the
                            same M = B x chunk through ``apply_linear`` (at
                            that M: W8A8; the report names the route that
                            ran), no attention / rope / LN / cache

On the card the port's ``attention`` sends every prompt-shaped block to K3
whatever ``attn_impl`` says, and the chunked context reaches only its plain
path, so (full) and (chunked), (fresh) and (fresh+flash) run the same
kernels there; each is timed all the same. A stage that fails raises (the
JAX script prints and goes on). Runs on the card unless ``--cpu``. The JAX
script's TPU figures are not carried over.

    python -m block_transformer_tpu_torch.scripts.prefill_profile \\
        [--batch 256] [--prefill 2048] [--kv int8] [--quantize int8]
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from block_transformer_tpu_torch.utils import profiling


def _timeit(report: dict, name: str, fn, *a):
    """Time ``fn(*a)``; its seconds into ``report[name]``. Returns the
    output of the last call."""
    box = []

    def run():
        box[:] = [fn(*a)]

    device = report["device"]
    dev, wall = profiling.event_timed(run, device)
    report["stages"][name] = {"s": wall, "device_s": dev}
    shown = f"{wall:8.3f} s" + ("" if dev is None else
                                 f"  (device {dev:8.3f} s)")
    print(f"{name:28s} {shown}", flush=True)
    return box[0]


def _launch_counts() -> dict:
    from block_transformer_tpu_torch.kernels import dequant_matmul as k1
    from block_transformer_tpu_torch.kernels import w8a8
    return {"K1": k1.int8_matmul_stacked.launches,
            "K4": k1.int4_matmul_stacked.launches,
            "W8A8-mm": w8a8.w8a8_matmul_stacked.launches}


def main(argv=None) -> dict:
    """Time every stage; returns {"stages": {name: {"s", "device_s"}},
    "matmul_floor_route": ..., ...}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--prefill", type=int, default=2048)
    ap.add_argument("--kv", default="int8")
    ap.add_argument("--quantize", default="int8")
    ap.add_argument("--chunk_blocks", type=int, default=128)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (plain versions) instead of the card")
    args = ap.parse_args(argv)

    from block_transformer_tpu_torch.config import get_config
    from block_transformer_tpu_torch.inference import generate as gen
    from block_transformer_tpu_torch.models import block_transformer as bt
    from block_transformer_tpu_torch.models import embedder as emb
    from block_transformer_tpu_torch.models import neox
    from block_transformer_tpu_torch.ops import attention as attn_ops
    from block_transformer_tpu_torch.ops import linear as linear_ops
    from block_transformer_tpu_torch.ops import masks as masks_mod
    from block_transformer_tpu_torch.ops import quant
    from block_transformer_tpu_torch.scripts import quality_run as qr

    device = qr.device_of(args)
    qr.log_device("prefill_profile", device)
    cfg = get_config("block_main_b4_1.2b")
    B, P, L = args.batch, args.prefill, cfg.block_length
    N = P // L
    n = cfg.n_embedding_tokens
    ph = cfg.embedder.projection_hidden_size
    dtype = torch.bfloat16
    i32 = dict(dtype=torch.int32, device=device)

    params = bt.init_block_transformer_params(0, cfg, dtype=dtype,
                                              device=device)
    if args.quantize != "none":
        params = quant.quantize_block_transformer(
            params, bits=8 if args.quantize == "int8" else 4)

    rng = np.random.default_rng(0)
    ids = torch.as_tensor(rng.integers(1, 50254, size=(B, N, L)), **i32)
    att = torch.ones((B, N, L), **i32)
    report = {"device": device, "batch": B, "prefill": P, "kv": args.kv,
              "quantize": args.quantize, "chunk_blocks": args.chunk_blocks,
              "stages": {}}

    # 1. embedder
    def embed_fn(p, i, a):
        return emb.embed_blocks(p["embedder"], cfg.embedder, L, i,
                                attention_mask=a)

    x_embeds = _timeit(report, "embedder", embed_fn, params, ids, att)

    # 2. block-decoder chunked prefill (the streaming formulation)
    S_total = N * n
    chunk = args.chunk_blocks * n
    n_chunks = -(-S_total // chunk)
    capacity = -(-(S_total + 128) // 128) * 128

    def block_prefill(p, x_embeds, kv=args.kv):
        cache = neox.make_kv_cache(cfg.block_decoder, B, capacity, kv,
                                   dtype=dtype, device=device)
        kv_valid = torch.zeros((B, capacity), **i32)
        pv = torch.ones((B, S_total), **i32)
        x_pad = x_embeds.reshape(B, S_total, ph)
        hs = []
        for c in range(n_chunks):
            sl = slice(c * chunk, (c + 1) * chunk)
            h, cache, kv_valid = gen._block_decoder_step(
                p, cfg, x_pad[:, sl], cache, kv_valid, pv[:, sl])
            hs.append(h[:, -1, :1])
        return torch.stack(hs)

    with torch.no_grad():
        _timeit(report, "block prefill (full)", block_prefill, params,
                x_embeds)

        # 2c. the same through the chunked online-softmax attention
        def block_prefill_chunked(p, x_embeds):
            with attn_ops.chunked_prefill_attention():
                return block_prefill(p, x_embeds)

        _timeit(report, "block prefill (chunked)", block_prefill_chunked,
                params, x_embeds)

        # 2d. fresh-KV single-pass prefill: attention reads the just-
        # computed K/V; the cache is write-only
        def block_prefill_fresh(p, x_embeds, bd_cfg=cfg.block_decoder):
            cache = neox.make_kv_cache(cfg.block_decoder, B, capacity,
                                       args.kv, dtype=dtype, device=device)
            x_pad = x_embeds.reshape(B, S_total, ph)
            pv = torch.ones((B, S_total), **i32)
            mask = masks_mod.block_decode_mask(0, S_total, S_total, pv, n)
            positions = torch.arange(S_total, **i32)
            h, cache = neox.neox_prefill_fresh(
                p["block_decoder"], x_pad, cfg=bd_cfg, mask=mask,
                positions=positions, cache=cache, q_tile=chunk)
            return h[:, -1, :1]

        _timeit(report, "block prefill (fresh)", block_prefill_fresh,
                params, x_embeds)

        # 2e. fresh prefill with attn_impl="pallas" (K3)
        bd_cfg_pallas = dataclasses.replace(cfg.block_decoder,
                                            attn_impl="pallas")
        _timeit(report, "block prefill (fresh+flash)",
                lambda p, x: block_prefill_fresh(p, x, bd_cfg_pallas),
                params, x_embeds)

        # 2b. the bf16-KV block prefill: the INT8-vs-bf16 delta isolates
        # the cache's quantize / dequantize cost
        if args.kv != "bf16":
            _timeit(report, "block prefill (bf16 KV)",
                    lambda p, x: block_prefill(p, x, "bf16"), params,
                    x_embeds)

        # 3. matmul floor: the same 12 layers x (QKV, O, up, down) at the
        # same M and weights, chained (no attention / LN / rope / cache)
        bd = params["block_decoder"]["layers"]
        M = B * chunk

        def matmul_floor(layers, x2):
            h = x2
            for _ in range(n_chunks):
                for i in range(cfg.block_decoder.num_layers):
                    def view(name1, name2):
                        return linear_ops.StackedLinear(
                            layers[name1][name2], i)
                    qkv = linear_ops.apply_linear(h, view("attn", "qkv"))
                    h = linear_ops.apply_linear(
                        qkv[..., :ph].to(h.dtype).contiguous(),
                        view("attn", "out")) + h
                    up = linear_ops.apply_linear(h, view("mlp", "up"))
                    dn = linear_ops.apply_linear(up.to(h.dtype),
                                                 view("mlp", "down"))
                    h = h + dn.to(h.dtype)
                h = h * 0.5
            return h

        x2 = torch.as_tensor(rng.standard_normal((M, ph))).to(
            dtype).to(device)
        before = _launch_counts()
        _timeit(report, "matmul floor", matmul_floor, bd, x2)
        ran = {k: v - before[k] for k, v in _launch_counts().items()}
    route = [k for k, v in ran.items() if v] or ["plain"]
    report["matmul_floor_route"] = "+".join(route)
    report["matmul_floor_launches"] = ran
    report["card"] = profiling.card_label(device)
    print(f"matmul floor route at M = {M}: {report['matmul_floor_route']} "
          f"({ran}); card: {report['card']}")
    return report


if __name__ == "__main__":
    main()
