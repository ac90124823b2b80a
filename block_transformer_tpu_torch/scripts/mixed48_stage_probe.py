"""Stage-level race: the token decoder's decode step under INT8 against
mixed48 weights (port of ``scripts/mixed48_stage_probe.py``).

``block_main_b4_1.2b`` at random weights (seed 0, bf16), quantized INT8
(``bits=8``) and mixed48 (block decoder and LM head INT8, token decoder
INT4 g128), at ``--batch`` 128, prompt 2048 and 128 new tokens, the block
decoder's cache ``--kv`` (INT4 by default). The token stage streams the
token decoder's weights a block step, so INT4 there should cut its time
toward half. The three stages are timed by the port's benchmark's
``_two_level_decomposition`` (``block_transformer_tpu_torch/bench.py``,
the counterpart of the JAX benchmark's).

Runs on the card unless ``--cpu``. The JAX script's TPU figures are not
carried over.

    python -m block_transformer_tpu_torch.scripts.mixed48_stage_probe \\
        [--batch 128] [--kv int4]
"""

from __future__ import annotations

import argparse

import torch

from block_transformer_tpu_torch.bench import _two_level_decomposition
from block_transformer_tpu_torch.utils import profiling


def main(argv=None) -> dict:
    """Decompose under INT8 and mixed48 weights; returns {name: the
    decomposition}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--kv", default="int4")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (plain versions) instead of the card")
    args = ap.parse_args(argv)

    from block_transformer_tpu_torch.config import get_config
    from block_transformer_tpu_torch.models import block_transformer as bt
    from block_transformer_tpu_torch.ops import quant
    from block_transformer_tpu_torch.scripts import quality_run as qr

    device = qr.device_of(args)
    qr.log_device("mixed48_stage_probe", device)
    cfg = get_config("block_main_b4_1.2b")
    dtype = torch.bfloat16
    base = bt.init_block_transformer_params(0, cfg, dtype=dtype,
                                            device=device)
    report = {}
    for name, kwargs in [
            ("int8", {"bits": 8}),
            ("mixed48", {"bits": 8, "token_decoder_bits": 4,
                         "lm_head_bits": 8, "group_size": 128})]:
        params = quant.quantize_block_transformer(base, **kwargs)
        d = _two_level_decomposition(params, cfg, args.batch, 2048, 128,
                                     dtype, args.kv)
        report[name] = d
        print(f"{name:8s} token {d['token_decoder_ms_per_block_step']:.2f} "
              f"ms/block-step   block "
              f"{d['block_decoder_ms_per_block_step']:.2f} ms/block-step"
              + ("" if "device_prefill_ms" not in d else
                 f"   (device: token "
                 f"{d['device_token_decoder_ms_per_block_step']:.2f}, block "
                 f"{d['device_block_decoder_ms_per_block_step']:.2f})"),
              flush=True)
        del params
    report["card"] = profiling.card_label(device)
    return report


if __name__ == "__main__":
    main()
