"""Probe: one decode step over a bf16, an INT8 and an INT4 KV cache (port of
``scripts/int4kv_probe.py``).

B = 128 rows, H = 16 heads of D = 128, CAP = 640 slots. Each of ``ITERS``
iterations writes one new K position (q * 0.5, quantized for the quantized
caches) at slot ``i % CAP``, then attends the query over the whole cache; its
output is the next iteration's query. Each cache runs the path the port's
``models/neox.py`` stack takes for it at a decode step:

- bf16: a slice write, then K2's bf16 form (``decode_attention_stacked``);
- INT8: K5 fused with the quantization (``paged_quantize_write_int8`` at an
  int position, the cache a pool of one page a row), then K2 INT8
  (``decode_attention_int8_stacked``). The JAX script writes K alone, so the
  fused write is handed K's buffers for both of its rows;
- INT4: ``quantize_kv(bits=4)`` and ``pack_kv_int4`` (two values a byte,
  split half), a slice write, ``dequantize_kv`` of the whole cache and
  ``ops/attention.py`` ``attention`` (the plain path at one query row), as
  JAX's probe measures XLA's convert.

The JAX script loops inside one ``jit``; here the steps are issued from
Python, timed by CUDA events (device ms a step) and the host clock (wall).
The GB/s is the cache's bytes (values only, as the JAX script counts them)
over the device time. Runs on the card unless ``--cpu``. The JAX script's
docstring figures were taken on a TPU and are not carried over.

    python -m block_transformer_tpu_torch.scripts.int4kv_probe
"""

from __future__ import annotations

import argparse

import torch

from block_transformer_tpu_torch.kernels import decode_attention as k2
from block_transformer_tpu_torch.kernels import paged_attention as kp
from block_transformer_tpu_torch.ops import attention as attn_ops
from block_transformer_tpu_torch.ops import masks
from block_transformer_tpu_torch.ops import quant
from block_transformer_tpu_torch.utils import profiling

B, H, CAP, D = 128, 16, 640, 128
ITERS = 32


def timed(fn, *args):
    """(device s, wall s) a step of the chain ``fn(*args)``."""
    dev, wall = profiling.event_timed(lambda: fn(*args), args[0].device)
    return (None if dev is None else dev / ITERS), wall / ITERS


def _full_mask(Q: int, K: int, device) -> masks.AttnMask:
    """Every query row sees every key (the JAX script's attention is
    unmasked)."""
    return masks.AttnMask(torch.full((Q,), K - 1, dtype=torch.int32,
                                     device=device),
                          torch.arange(K, dtype=torch.int32, device=device),
                          None)


def softmax_attn(q, k, v):
    """Unmasked attention of q [B, H, Q, D] over k, v [B, H, K, D] through
    the port's ``attention``."""
    return attn_ops.attention(q, k, v, _full_mask(q.shape[2], k.shape[2],
                                                  q.device))


def chain_bf16():
    def run(q, K, V):
        """K, V [B, H, CAP, D] of q's dtype, written in place."""
        cap = K.shape[2]
        mask = _full_mask(1, cap, q.device)
        for i in range(ITERS):
            K[:, :, i % cap] = (q[:, :, 0, :] * 0.5).to(K.dtype)
            q = k2.decode_attention_stacked(q.contiguous(), K[None], V[None],
                                            0, mask)
        return q
    return run


def chain_quant(qdtype, qmax):
    """``qdtype`` torch.int8 (INT8 cache, ``qmax`` 127) or torch.uint8 (INT4
    packed two values a byte, ``qmax`` 7: the port tells a packed cache by
    its dtype)."""
    int4 = qdtype == torch.uint8

    def run(q, K, V, ks, vs):
        """K, V int8 values [B, H, CAP, D] (INT4: in [-7, 7], packed here,
        as JAX casts them to int4 inside its ``jit``); ks, vs float32 [B, H,
        CAP], written in place."""
        cap = K.shape[2]
        if int4:
            K, V = quant.pack_kv_int4(K), quant.pack_kv_int4(V)
        mask = _full_mask(1, cap, q.device)
        for i in range(ITERS):
            newk = q[:, :, 0, :] * 0.5
            if int4:
                nq, a = quant.quantize_kv(newk[:, :, None], bits=4)
                K[:, :, i % cap] = quant.pack_kv_int4(nq)[:, :, 0]
                ks[:, :, i % cap] = a[:, :, 0]
                q = softmax_attn(q, quant.dequantize_kv(K, ks, q.dtype),
                                 quant.dequantize_kv(V, vs, q.dtype))
            else:
                kp.paged_quantize_write_int8(K[None], ks[None], K[None],
                                             ks[None], 0, None, i % cap,
                                             newk, newk)
                q = k2.decode_attention_int8_stacked(
                    q.contiguous(), K[None], ks[None], V[None], vs[None], 0,
                    mask)
        return q
    return run


def inputs(device, dtype=torch.bfloat16):
    """(q [B, H, 1, D], K, V [B, H, CAP, D] of ``dtype``, scales f32 0.02
    [B, H, CAP], and the INT8 (K, V) = clip(round(50 x)), INT4 (K, V) =
    clip(round(3.5 x), -7, 7) values), drawn on ``device`` from seeds
    0, 1, 2."""
    g = torch.Generator(device)

    def normal(seed, shape):
        g.manual_seed(seed)
        return torch.randn(shape, generator=g, device=device).to(dtype)

    q = normal(0, (B, H, 1, D))
    Kf, Vf = normal(1, (B, H, CAP, D)), normal(2, (B, H, CAP, D))
    scales = torch.full((B, H, CAP), 0.02, dtype=torch.float32, device=device)

    def ints(x, mul, lim):
        return torch.clamp(torch.round(x.float() * mul), -lim, lim).to(
            torch.int8)

    return (q, Kf, Vf, scales, (ints(Kf, 50, 127), ints(Vf, 50, 127)),
            (ints(Kf, 3.5, 7), ints(Vf, 3.5, 7)))


def main(argv=None) -> list:
    """Time a decode step over each cache; returns one row a cache (device
    and wall ms a step, the cache's GB/s)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (plain versions) instead of the card")
    args = ap.parse_args(argv)

    from block_transformer_tpu_torch.scripts import quality_run as qr
    device = qr.device_of(args)
    qr.log_device("int4kv_probe", device)
    q, Kf, Vf, scales, (k8, v8), (k4, v4) = inputs(device)
    bytes_bf16 = 2 * B * H * CAP * D * 2
    rows = []
    for name, run, nbytes in [
            ("bf16 cache", lambda: timed(chain_bf16(), q, Kf, Vf),
             bytes_bf16),
            ("int8 cache", lambda: timed(chain_quant(torch.int8, 127.0), q,
                                         k8, v8, scales.clone(),
                                         scales.clone()), bytes_bf16 // 2),
            ("int4 cache", lambda: timed(chain_quant(torch.uint8, 7.0), q,
                                         k4, v4, scales.clone(),
                                         scales.clone()), bytes_bf16 // 4)]:
        dev, wall = run()
        t = wall if dev is None else dev
        rows.append({"cache": name, "ms_per_step": None if dev is None
                     else dev * 1e3, "wall_ms_per_step": wall * 1e3,
                     "GB/s": nbytes / t / 1e9, "cache_bytes": nbytes})
        print(f"{name:12s} {t * 1e3:7.3f} ms/step  {nbytes / t / 1e9:6.0f} "
              f"GB/s cache stream  (wall {wall * 1e3:.3f})", flush=True)
    print(f"card: {profiling.card_label(device)}")
    return rows


if __name__ == "__main__":
    main()
