"""INT8 against bf16 at square weights, each output chained straight into
the next iteration (port of ``scripts/w8a8_probe2.py``): M = 32768,
K = N = 4096.

  ``bf16_body``       ``torch.matmul``, times 0.01 (a library product)
  ``w8a8_body``       W8A8-q, then W8A8-mm with the output scale 0.001
  ``int8_pure_body``  an s8 x s8 product shifted right by 8 into int8: here
                      W8A8-mm with unit row scales and column scales of
                      1/256, then floor. The kernel (and its plain version)
                      rounds the int32 sum to float32 before scaling, so
                      where |sum| >= 2^24 the result may differ from the
                      exact ``sum >> 8`` by one; ``kernels/w8a8.py``
                      ``int_product`` gives the exact sum.

The JAX script loops each body inside one ``jit``; here the iterations are
issued from Python, timed by CUDA events (device) and the host clock
(wall). Runs on the card unless ``--cpu``. No TPU figure is carried over.

    python -m block_transformer_tpu_torch.scripts.w8a8_probe2
"""

from __future__ import annotations

import argparse

import torch

from block_transformer_tpu_torch.kernels import w8a8
from block_transformer_tpu_torch.utils import profiling

M, K = 32768, 4096
ITERS = 20


def timed(fn, *args):
    """(device s, wall s) an iteration of the chain ``fn(*args)``."""
    dev, wall = profiling.event_timed(lambda: fn(*args), args[0].device)
    return (None if dev is None else dev / ITERS), wall / ITERS


def chain(body):
    def run(x, w):
        for _ in range(ITERS):
            x = body(x, w)
        return x
    return run


def bf16_body(x, w):
    return torch.matmul(x, w) * 0.01   # keep magnitudes bounded


def _col_scale(w_q, value: float):
    """W8A8-mm's [1, N] column scales, all ``value`` (float32)."""
    return torch.full((1, w_q.shape[1]), value, dtype=torch.float32,
                      device=w_q.device)


def w8a8_body(x, w_q):
    xq, sx = w8a8.w8a8_quant(x)
    return w8a8.w8a8_matmul_stacked(xq, sx, w_q[None], _col_scale(w_q, 0.001),
                                    0, x.dtype)


def int8_pure_body(xq, w_q):
    ones = torch.ones((xq.shape[0],), dtype=torch.float32, device=xq.device)
    y = w8a8.w8a8_matmul_stacked(xq, ones, w_q[None],
                                 _col_scale(w_q, 1 / 256), 0, torch.float32)
    # floor(sum / 256) is sum >> 8; int32 then int8 wraps as JAX's astype
    return torch.floor(y).to(torch.int32).to(torch.int8)


def inputs(device):
    """(x bf16 [M, K], w bf16 [K, K] (0.01 N(0, 1)), w_q = clip(round(1600
    w)), xq = clip(round(16 x))), drawn on ``device`` from seeds 0, 1."""
    g = torch.Generator(device).manual_seed(0)
    x = torch.randn((M, K), generator=g, device=device).to(torch.bfloat16)
    g.manual_seed(1)
    w = torch.randn((K, K), generator=g, device=device).to(
        torch.bfloat16) * 0.01
    w_q = torch.clamp(torch.round(w.float() * 1600), -127, 127).to(torch.int8)
    xq = torch.clamp(torch.round(x.float() * 16), -127, 127).to(torch.int8)
    return x, w, w_q, xq


def main(argv=None) -> list:
    """Time the three chains; returns one row a body."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (plain versions) instead of the card")
    args = ap.parse_args(argv)

    from block_transformer_tpu_torch.scripts import quality_run as qr
    device = qr.device_of(args)
    qr.log_device("w8a8_probe2", device)
    x, w, w_q, xq = inputs(device)
    rows = []
    for name, body, a, b in [("bf16 dot", bf16_body, x, w),
                             ("W8A8 dyn-quant", w8a8_body, x, w_q),
                             ("pure s8xs8 dot", int8_pure_body, xq, w_q)]:
        dev, wall = timed(chain(body), a, b)
        t = wall if dev is None else dev
        rows.append({"name": name, "ms_per_iter": None if dev is None
                     else dev * 1e3, "wall_ms_per_iter": wall * 1e3,
                     "TFLOP/s": 2 * M * K * K / t / 1e12})
        print(f"{name:20s} {t * 1e3:8.3f} ms/iter  "
              f"{rows[-1]['TFLOP/s']:7.1f} TFLOP/s  (wall {wall * 1e3:.3f})",
              flush=True)
    print(f"card: {profiling.card_label(device)}")
    return rows


if __name__ == "__main__":
    main()
