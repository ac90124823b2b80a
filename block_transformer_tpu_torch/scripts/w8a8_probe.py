"""Probe: the prefill-shaped INT8 products against bf16 (port of
``scripts/w8a8_probe.py``).

Races three chains of ``ITERS`` data-dependent iterations (each folds the
whole output back into x, so no iteration can be skipped) at M = 32768,
K = 2048, N = 8192:
  1. ``bf16_body``     bf16 x bf16, ``torch.matmul`` (a library product: the
                       JAX script's is an XLA dot outside any Pallas kernel)
  2. ``convert_body``  INT8 weights, K1 (``kernels/dequant_matmul.py``
                       ``int8_matmul``)
  3. ``w8a8_body``     per-row dynamic INT8 activations, W8A8-q then W8A8-mm
                       (``kernels/w8a8.py``)

The JAX script loops each body inside one ``jit``; here the same iterations
are issued from Python with the same data dependence, timed by CUDA events
(device ms an iteration, the host's launch cost left out) and by the host
clock (wall ms). Runs on the card unless ``--cpu`` (there every body takes
its kernel's plain version). The JAX script's docstring figures were taken
on a TPU and are not carried over.

    python -m block_transformer_tpu_torch.scripts.w8a8_probe
"""

from __future__ import annotations

import argparse

import torch

from block_transformer_tpu_torch.kernels import dequant_matmul as k1
from block_transformer_tpu_torch.kernels import w8a8
from block_transformer_tpu_torch.utils import profiling

M, K, N = 32768, 2048, 8192
ITERS = 20


def timed(fn, *args):
    """(device s, wall s) an iteration of ``fn(*args)``, a chain of
    ``ITERS`` iterations, after one untimed run."""
    dev, wall = profiling.event_timed(lambda: fn(*args), args[0].device)
    return (None if dev is None else dev / ITERS), wall / ITERS


def chain(body):
    def run(x, w, s):
        for _ in range(ITERS):
            y = body(x, w, s)
            # fold the FULL output back into x (a sum over the N / K column
            # groups), so every iteration depends on the last
            fold = y.reshape(y.shape[0], -1, x.shape[1]).sum(dim=1)
            x = x + fold.to(x.dtype) * 1e-6
        return x
    return run


def bf16_body(x, w, s):
    return torch.matmul(x, w)


def convert_body(x, w_q, s):
    return k1.int8_matmul(x, w_q, s)


def w8a8_body(x, w_q, s):
    xq, sx = w8a8.w8a8_quant(x)
    return w8a8.w8a8_matmul_stacked(xq, sx, w_q[None], s[None], 0, x.dtype)


def inputs(device, dtype=torch.bfloat16):
    """(x [M, K], w [K, N], w_q int8 [K, N], s f32 [N]) drawn on ``device``
    from seeds 0 and 1; w_q = clip(round(16 w)), s = 1/16."""
    g = torch.Generator(device).manual_seed(0)
    x = torch.randn((M, K), generator=g, device=device).to(dtype)
    g.manual_seed(1)
    w = torch.randn((K, N), generator=g, device=device).to(dtype)
    w_q = torch.clamp(torch.round(w.float() * 16), -127, 127).to(torch.int8)
    s = torch.full((N,), 1 / 16.0, dtype=torch.float32, device=device)
    return x, w, w_q, s


def main(argv=None) -> list:
    """Time the three chains; returns one row a body (device and wall ms an
    iteration, TFLOP/s by the device time, or by the wall time off the
    card)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (plain versions) instead of the card")
    args = ap.parse_args(argv)

    from block_transformer_tpu_torch.scripts import quality_run as qr
    device = qr.device_of(args)
    qr.log_device("w8a8_probe", device)
    x, w, w_q, s = inputs(device)
    rows = []
    for name, body, wa in [("bf16 dot", bf16_body, w),
                           ("int8w convert+dot", convert_body, w_q),
                           ("W8A8 dyn-quant int8 dot", w8a8_body, w_q)]:
        dev, wall = timed(chain(body), x, wa, s)
        t = wall if dev is None else dev
        rows.append({"name": name, "ms_per_iter": None if dev is None
                     else dev * 1e3, "wall_ms_per_iter": wall * 1e3,
                     "TFLOP/s": 2 * M * K * N / t / 1e12})
        print(f"{name:28s} {t * 1e3:8.3f} ms/iter  "
              f"{rows[-1]['TFLOP/s']:7.1f} TFLOP/s  (wall {wall * 1e3:.3f})",
              flush=True)
    print(f"card: {profiling.card_label(device)}")
    return rows


if __name__ == "__main__":
    main()
