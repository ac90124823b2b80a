"""Per-shape W8A8 probe at the 1.2B block decoder's prefill linears (port of
``scripts/w8a8_probe3.py``).

Races, for each (K, N) of ``SHAPES`` at prefill M = 32768:
  1. ``bf16_body``     bf16 x bf16, ``torch.matmul`` (a library product)
  2. ``convert_body``  INT8 weights, K1 (``int8_matmul``)
  3. ``w8a8_body``     per-row dynamic INT8 activations, W8A8-q + W8A8-mm

Each chain's feedback is ``x + 1e-9 * rowsum(y)``, as in the JAX script:
every output element feeds the next iteration. The iterations are issued
from Python (the JAX script loops inside one ``jit``), timed by CUDA events
(device) and the host clock (wall). Runs on the card unless ``--cpu``. No
TPU figure is carried over.

    python -m block_transformer_tpu_torch.scripts.w8a8_probe3
"""

from __future__ import annotations

import argparse

import torch

from block_transformer_tpu_torch.kernels import dequant_matmul as k1
from block_transformer_tpu_torch.kernels import w8a8
from block_transformer_tpu_torch.utils import profiling

M = 32768
ITERS = 20
SHAPES = [  # block/token decoder H=2048, QKV 3H, MLP 4H
    ("qkv   2048->6144", 2048, 6144),
    ("attn_o 2048->2048", 2048, 2048),
    ("mlp_up 2048->8192", 2048, 8192),
    ("mlp_dn 8192->2048", 8192, 2048),
]


def timed(fn, *args):
    """(device s, wall s) an iteration of the chain ``fn(*args)``."""
    dev, wall = profiling.event_timed(lambda: fn(*args), args[0].device)
    return (None if dev is None else dev / ITERS), wall / ITERS


def chain(body):
    def run(x, w, s):
        for _ in range(ITERS):
            y = body(x, w, s)
            fold = torch.sum(y.float(), dim=1, keepdim=True)
            x = x + (fold * 1e-9).to(x.dtype)
        return x
    return run


def bf16_body(x, w, s):
    return torch.matmul(x, w)


def convert_body(x, w_q, s):
    return k1.int8_matmul(x, w_q, s)


def w8a8_body(x, w_q, s):
    xq, sx = w8a8.w8a8_quant(x)
    return w8a8.w8a8_matmul_stacked(xq, sx, w_q[None], s[None], 0, x.dtype)


def inputs(K: int, N: int, device):
    """(x bf16 [M, K], w bf16 [K, N], w_q = clip(round(16 w)), s = 1/16),
    drawn on ``device`` from seeds 0 and 1."""
    g = torch.Generator(device).manual_seed(0)
    x = torch.randn((M, K), generator=g, device=device).to(torch.bfloat16)
    g.manual_seed(1)
    w = torch.randn((K, N), generator=g, device=device).to(torch.bfloat16)
    w_q = torch.clamp(torch.round(w.float() * 16), -127, 127).to(torch.int8)
    s = torch.full((N,), 1 / 16.0, dtype=torch.float32, device=device)
    return x, w, w_q, s


def main(argv=None) -> list:
    """Time the three chains at each shape; returns one row a shape (device
    and wall ms an iteration and TFLOP/s by body)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (plain versions) instead of the card")
    args = ap.parse_args(argv)

    from block_transformer_tpu_torch.scripts import quality_run as qr
    device = qr.device_of(args)
    qr.log_device("w8a8_probe3", device)
    rows = []
    for name, K, N in SHAPES:
        x, w, w_q, s = inputs(K, N, device)
        flops = 2 * M * K * N
        row, text = {"shape": name, "K": K, "N": N}, [name]
        for label, body, wa in [("bf16", bf16_body, w),
                                ("int8w_convert", convert_body, w_q),
                                ("w8a8", w8a8_body, w_q)]:
            dev, wall = timed(chain(body), x, wa, s)
            t = wall if dev is None else dev
            row[label] = {"ms_per_iter": None if dev is None else dev * 1e3,
                          "wall_ms_per_iter": wall * 1e3,
                          "TFLOP/s": flops / t / 1e12}
            text.append(f"{t * 1e3:7.3f}ms {flops / t / 1e12:6.1f}TF")
        rows.append(row)
        print("  ".join(text), flush=True)
        del x, w, w_q, s
    print("columns: bf16 | int8w convert+dot | W8A8 dyn-quant (device ms; "
          f"wall in the report); card: {profiling.card_label(device)}")
    return rows


if __name__ == "__main__":
    main()
