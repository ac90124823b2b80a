#!/usr/bin/env python3
"""Drive the PyTorch port (``block_transformer_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card; exits non-zero, printing no result, without one. In
one process (and, for step 12, two more on the same card) it:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the CUDA kernels K1-K8, W8A8-q and W8A8-mm from
   ``block_transformer_tpu_torch/csrc`` (one ``nvcc`` per source, in
   parallel) and prints ptxas's register and spill lines;
3. holds each kernel against its plain PyTorch version on the card at the
   shapes its main path gives it, in bf16, and times kernel, plain version,
   one PyTorch library call computing the same function (a yardstick only:
   the port never calls it) and the bound from the data (device times, with
   the launch queue filled first so that host cost is left out; K1 and K4
   rows also give their wrapper's host microseconds a call): K1-K4 at
   generation with ``block_main_b4_1.2b`` at B=8, prompt 2048 tokens and
   128 new tokens (K1 and K4 at decode M = 8, the token decoder's M = 32
   prefix step and the M = 4096 prefill, each row naming the route, tile
   and split ``plan`` gave it; K2 at the block decoder's decode step and K3
   at the prefill's first and last query tiles); K2's bf16 form at the
   block decoder's decode step over a bf16 cache (split route) and at the
   token decoder's local cache, its token step and its prefix step (warp
   route); K2 and K3 also at the ``vanilla_410`` baseline's decode step
   (D = 64, capacity 2176) and prompt (Q = 2048 causal), each K2 row
   naming its route and split of the cache and each K3 row its route;
   W8A8-q and W8A8-mm (bit for bit) at the prefill's linears, the block
   decoder's four at M = 4096 and the baseline's qkv at M = 16384, beside
   ``torch._int_mm`` and K1 at the same shape (each W8A8-mm row naming
   the route, tile, splits and grid ``plan`` gave it, its wrapper's host
   microseconds a call and its share of the int8 peak), then the W8A8
   pair against K1 at M from 256 to 4096 (``w8a8_crossover``, one JSON
   line);
   K5-K8 at the serving engine's shapes (16 slots, 12 layers, 16 heads of
   128, capacity 640 contiguous, 3 pages of 256 paged), K6 and K8 also on
   the packed INT4 pool, each K6 row naming its split of the virtual slots;
   K5 fused with the INT8 KV quantization (bit for bit) at the decode
   write of the ``engine int8`` cache (per-row offsets), of generation's
   global cache and of the baseline's cache (one int offset), and K7's
   fused forms at the paged engine's step (a layer's step buffers and
   fresh pair; the last layer's, carrying K7), each beside the device ms
   and host us of the unfused sequence the parent ran;
   then the ablation families' new shapes (hidden 768, heads of 64):
   W8A8-q/-mm at ``block_uniform_b4_85``'s prefill qkv (M = 2344, bit for
   bit), K3 at its last, partial query tile (Q = 37 of K = 293), K2 bf16
   at its local cache (capacity 9, warp route), K2 INT8 at
   ``block_megabyte_b4_85``'s decode step (capacity 640) and K1 at its
   token decoder's qkv (M = 32, K = 512, N = 1536);
   then the kernels of step 17's path at its batch (B = 16): K1 at decode
   M = 16, W8A8 at both prefills (M = 8192 and 32768), K2 INT8 and K3 as
   above, K2's warp route at the token decoder's local cache and the fused
   K5 at both decode writes (K2's split of the cache and K3's grid follow
   B x H);
   then an empty kernel's launch, timed the same way, printed on its own
   line as ``launch_floor_ms`` beside the card's name and power limit;
4. checks the port on the card against the same port on the CPU (plain
   versions) at a small configuration in float32: forward logits, greedy
   tokens of INT8-weight generation with the INT8, INT4 and bf16 global
   caches, of INT4- and mixed48-weight INT8-KV generation, of the vanilla
   baseline (INT8 and INT4 weights, INT8 KV), of the serving engine
   with each of its four quantized caches (contiguous INT8 and INT4, paged
   INT8 and INT4; K3's route logged and checked), of ``block_main_b4_5``
   (INT8) with W8A8 at every M, and of the streaming prefill on the bf16,
   INT8 and INT4 caches; then the quantization workflow at
   ``block_main_b4_5``: two train steps, plain and QAT ``mixed48`` (loss,
   grad_norm and every parameter leaf within
   1e-5 relative of the CPU's), and GPTQ INT4 trees (at least 99.9% of Q
   equal to the CPU's, the rest one step apart, the differences counted);
   then every ablation family at a small size (INT8 weights): forward
   logits within TOL, and greedy tokens equal with the INT8 global cache
   (the RoBERTa, RoBERTa-CLS and T5 embedders, the projection layer, the
   summation and T5 cross-attention token decoders) or, for the GPT-Neo
   block decoder, the unquantized cache through the streaming prefill;
5. generates with ``block_main_b4_1.2b`` at full width (random weights from
   a seed, bf16), greedy, B=8, p2048/d128: INT8 weights with the INT8,
   bf16 and INT4 global caches, then INT4 weights (no K1 launch) and
   mixed48 weights (block decoder and head INT8, token decoder INT4) with
   the INT8 cache, and INT8 weights with the streaming prefill (4 chunks
   of 128 blocks through the INT8 cache): each one warm-up run, then a
   timed run between launch-count resets, asserting every kernel of the
   path ran in it (and none it must not run; K5 fused on every INT8
   cache, K5's and K7's own kernels on none), and that W8A8 took the 48
   prefill linears of each fresh prefill with INT8 block-decoder weights
   (M = 4096; none of the streaming chunks, M = 1024 under the INT8 cache)
   and K1 every other INT8 linear;
6. serves with ``ContinuousBatchingEngine`` at the same width (INT8
   weights), 16 slots, 24 requests submitted together (8 of 512 prompt
   tokens and 32 new ones, then 16 of 2048 and 128), once with each cache:
   contiguous INT8 and INT4, paged INT8 and INT4: a short warm-up, then a
   timed ``run()`` between launch-count resets; asserts every request is
   served and every kernel of the path ran, and logs how far the
   contiguous and paged caches of one width agree; then runs one
   block-decoder decode step from identical prefilled K/V through the
   contiguous and the paged stack of each width (K2 + K5 fused against K6
   with the fresh term + the fused K7; the INT4 cache against K6 INT4)
   and asserts the outputs agree within ``TOL`` of their largest
   magnitude;
7. generates greedily with the ``vanilla_410`` baseline (INT8 weights, INT8
   KV cache) at the same B, prompt and new tokens, the same way, and prints
   the block/vanilla throughput ratio as a smoke figure;
8. generates with the four shipped ablation configs at full width
   (``FAMILY_NAMES``, read by the port's YAML loader:
   ``block_megabyte_b4_85``,
   ``block_ablation_b4_85_cls_cross_attn``, ``block_uniform_b4_85``,
   ``block_ablation_b4_85_roberta_prefix``; random bf16 weights from a
   seed, INT8 weights and global cache, greedy, B=8, 2048 prompt tokens
   rounded up to whole blocks, 128 new ones): one warm-up run, a timed run
   between launch-count resets (K1, K2, K3 and W8A8 on their main routes
   in every one; K2's bf16 form by the warp route on the local cache of
   the two prefix decoders and not on the two re-run ones), then the
   prefill alone and a run with the inner loop timed, each logged with
   run s, tok/s and prefill s and as one JSON line;
9. trains ``block_main_b4_1.2b`` at full width (random float32 weights from
   a seed, two sequences of 2048 tokens, remat, TF32 off): 3 steps, then 3
   QAT ``mixed48`` steps from a fresh optimizer, each logged with its ms,
   tokens per second, peak memory and loss, asserting finite losses and
   that no kernel launched (K3 included: attention under autograd stays on
   the plain path); quantizes the fine-tuned weights with the recipe and
   generates from them as in step 5 (W8A8 at the prefill and K1 for the
   INT8 block decoder and head, K4 for the INT4 token decoder); then runs
   GPTQ INT4 g128 on the card from the same two sequences, logging each
   trunk's calibration and rounding seconds and the layer-output error of
   GPTQ and RTN for the first and last layers' four linears, and generates
   from the GPTQ tree (K4 only, no K1);
10. trains through the training loop (``phase_trainer``; checkpoints under
   a temporary directory of ``build/``, removed afterwards): the native
   packer against numpy on 2048-token samples; (d) a tiny trainer (hidden
   64, accumulation 2, ramp-up 2) 3 steps on the card and on the CPU from
   one initial state, float32, every record within 1e-4 relative; (a)
   ``block_main_b4_1.2b`` through ``pretrain_block_transformer.main`` with
   ``configs/block_main_b4_1.2b.yaml`` (bf16), a synthetic corpus and
   2048-token samples, batch 2, 2 steps; (b) the same model through
   ``Trainer``, total batch 4 of micro 2, ramp-up 1, 3 steps saving at
   step 2, then a second ``Trainer`` resumed from it to step 3 (its loss
   within 1e-3 relative of the uninterrupted run's), each step's s and
   tokens/s, peak memory, checkpoint bytes and save / restore s; (c)
   ``vanilla_160`` through ``pretrain_vanilla_transformer.main`` for 2
   steps, its parameters uptrained (``partition``) into
   ``block_uptrain_b4_85_10``'s decoders, 2 steps more; no hand kernel
   may launch in any of them;
11. evaluates (``phase_eval``): (d) exports the full-width bf16
   ``block_main_b4_1.2b`` tree to the HF safetensors layout under a
   temporary directory of ``build/`` and reads it back onto the card, every
   leaf equal bit for bit; (a) the fixture suite of ``assets/real_tasks``
   through ``harness.evaluate`` and ``BlockTransformerLM`` (INT8 weights,
   the byte tokenizer, batch 8, max_length 2048): LambadaOpenAI on 64
   docs and Wikitext on 4 (the ``eval score`` path: W8A8 and K3, no cache
   kernel), then TriviaQA on 8 docs zero-shot and 5-shot and GSM8K on 2
   (``eval generate``: K1, K2 bf16 by both routes, K3, W8A8), each task's
   seconds, requests/s and scored tokens/s and finite metrics (random
   weights: no measure of quality); kernel rows at the scoring forward's
   longest batch: K3 over its 513 blocks, W8A8-q/-mm at the LM head (N =
   50304, a partial last tile) and the token decoder's mlp_up, asserting
   the path took W8A8 at those M; (e) ``decompose_generation`` at B = 8
   (INT8) with ``mfu_summary`` on the H100's peaks; (b) ``VanillaLM`` with
   ``vanilla_410`` (INT8) on the 64 lambada docs (``eval vanilla``); (c)
   ``eval_longctx.main`` in ``ppl`` mode (4 chunks of 2048) and ``needle``
   mode (depths 0, 50, 100); (f) the adapter on the card against the CPU
   at the small configuration with INT8 and with INT4 weights (float32
   loglikelihoods within EVAL_F32_TOL, greedy flags and generations equal;
   K3 by its CUDA-core route there, head dim 32, K1 and K4 by their TF32
   route, and a row of K3 and K1 counting those launches: K3 at that
   scoring shape, K1 at a float32 decode shape of ``block_main_b4_1.2b``
   within K14_F32_TOL beside its CUDA-core kernel) and
   ``pretrain_block_transformer.main --from_vanilla`` on a tiny vanilla
   tree in the HF layout, one step; (g) the eval entry points as a user
   calls them, at full width with float32 weights and ``--quantize int8``
   on the byte tasks of a corpus written from the fixtures:
   ``eval_zero_shot_task.main --random``, the same tree saved as
   ``checkpoint-1`` and scored through ``--ckpt``, then
   ``export_checkpoint.main`` on it and ``--ckpt`` of the HF tree, the
   three results equal within EVAL_F32_TOL (``eval entry``: W8A8 and K3
   by its float32 tensor-core route, 3xTF32); ``--random --quantize int4``
   (``eval entry int4``: every linear by K4's TF32 route, ``tf32x2``, K3 by
   ``tf32x3``, no K1 and no W8A8); and kernel rows in float32 at its
   longest batch (K3 within K3_F32_TOL of its plain version, beside its
   CUDA-core kernel timed at the same inputs; K4 at the int4 run's LM head
   and mlp_up within K14_F32_TOL, beside its CUDA-core kernel and
   ``torch.matmul`` on the dequantized float32 weight).

12. serves over a (data, model) mesh (``phase_tp``, run after step 7):
   (a) one rank in this process over NCCL, mesh (data 1, model 1): the
   tensor-parallel generator (``parallel/tp_decode.py``) with INT8 and
   with INT4 weights, INT8 global cache, and the engine over ``int8`` and
   ``paged``: every generated token's logit, from a teacher-forced
   forward over the row's own tokens (W8A8 off), lies within TOL *
   max|logit| of the best at its position, EOS too where a row ended, and
   the rows equal to the port on one device are counted; (b) two
   processes it spawns on the one card over gloo with CUDA tensors (NCCL
   takes one rank a device), mesh (data 1, model 2), 8 heads each: first
   the collectives the programs issue (one JSON line), then the generator
   (INT8) and ``engine int8``, the two ranks' tokens equal, checked the
   same way and counted against (a); every
   run asserts its launches by route (no W8A8 inside the TP programs);
   then K1 and K2 rows at the tp = 2 shard widths and one JSON line of
   each rank's all-reduces (count, mean host and device us) from a trace
   of two more blocks.

13. trains over a mesh (``phase_tp_train``, after step 12) at full width
   and 6 layers a stack (``TP_TRAIN_LAYERS``), bf16 parameters from seed
   0, two steps on one batch of 4 x 2048 tokens, remat: (a) one rank in
   this process over NCCL, mesh (data 1, model 1),
   ``make_sharded_grad_and_apply`` against
   ``make_grad_and_apply`` on the same state and batches (loss, grad norm
   and the state equal bit for bit after each step); (b) two processes it
   spawns on the one card over gloo with CUDA tensors: gloo's all-gather
   (bf16, float32) and its all-reduce rate on 1 GiB, then (data 2)
   with ZeRO moments, (data 1, model 2) and the pipeline over (pipe 2)
   with 4 micro-batches, each two steps, each step's loss and grad norm
   within TP_TRAIN_RTOL of (a)'s (step 2 reads the sharded update), the
   second step's collectives from a host trace, the data ranks'
   parameters equal bit for bit after each step and each rank holding
   half of every ZeRO-split moment; (c) the ``Trainer`` over (data 2) on
   the two ranks at one layer a stack, whose step-2 checkpoint restores
   into the one-device ``Trainer`` bit for bit (against the state the
   other rank gathered) and trains a third step there. No hand kernel
   launches.

14. runs the quantization-quality scripts (``phase_quality``, after step
   11) through their ``main(argv)`` at full width (``block_main_b4_5``,
   byte vocab, max length 1024, float32) under a temporary directory of
   ``build/``: ``build_byte_corpus`` over this Python's stdlib (20 MB),
   ``quality_run --gptq`` (150 steps of the block model and of
   ``vanilla_31``, then held-out ppl at fp32, INT8 with W8A8, INT4, mixed48
   and the INT4 gate recipe, the byte harness tasks and the decode
   agreement), ``decode_gate --w8a8 --gptq`` at batch 384, prompt 256 and
   64 new tokens, ``qat_finetune --recipe mixed48 --distill`` (50 steps)
   and ``qat_ppl_gate``, ``gptq_gate`` (two configurations),
   ``kv_quality_cpu``, ``longctx_quality_cpu`` and ``real_task_eval
   --limit 8``, each cut logged. The launch counts, set to 0 just before
   the first script and read just after the last, must show K1, K4 (TF32
   route), W8A8-q/-mm, K2 (INT8 and bf16), K3 (CUDA-core route) and fused
   K5 (``quality launches``). Then, outside that window, it asserts the
   trained fp32 ppl at most a tenth of the untrained parameters', the
   card's held-out ppl within 1e-4 relative of the CPU's (fp32, INT8 under
   ``w8a8_disabled``: K1, INT4 g128: K4), INT8 with W8A8 within 1% of
   fp32 and the decode gate's reference decode rescored on the CPU within
   1e-4; then ``kv_scheme_probe`` on the trained checkpoint (four schemes,
   K3 by its CUDA-core route, K2 bf16 by both routes, in a launch window
   of its own); then kernel rows at its shapes.

15. runs the entry scripts (``phase_scripts``) through their
   ``main(argv)`` on the card under a temporary directory of ``build/``,
   each in a launch window of its own (K2 bf16 by route and K3 by route
   logged and asserted; none of K1, K2 INT8, K4, W8A8 or the serving
   kernels: bf16 weights and caches): ``inference_demo`` at
   ``block_main_b4_1.2b`` (B = 32, p512 to 640), ``measure_generation_time``
   at ``block_main_b4_1.2b`` and ``vanilla_410`` (B = 8, p128/d64, 2
   repeats), then ``--batch auto`` (the batch it chose logged, peak memory
   at most the card's), ``train_mfu`` at ``block_main_b4_1.2b`` (B = 2 x
   2048, vocab 50304, float32: no kernel launch), ``train_ckpt`` at
   ``block_main_b4_85`` for 4 steps on a 2 MB ``build_byte_corpus``
   corpus, ``longctx_85m`` on that checkpoint at a context of 8192 (2
   docs, depths 0, 50, 100) and ``bench_packer`` on 20,000 documents (the
   native and numpy batches equal); each cut and each script's seconds
   logged.
16. runs the ten speed probes (``phase_probes``; ``w8a8_decode_gate`` in
   step 14 on its trained checkpoint): first each probe's kernels against
   their plain versions on its inputs at its shapes (W8A8-q / W8A8-mm and
   K5 fused bit for bit, ``int8_pure_body``'s shift within the float32
   rounding of sums past 2^24, the rest within TOL), then each ``main``
   in a launch window of its own (every kernel of it launched, none it
   must not, routes asserted): ``w8a8_probe{,2,3}`` at M = 32768,
   ``int4kv_probe`` (B = 128, cap 640), ``kernel_microbench`` (K1 / K4 at
   M = 256, K2 INT8 at B = 256 and 64, K3 causal at Q = 2048),
   ``prefill_profile`` (1.2b, batch cut to 64), ``mixed48_stage_probe``
   (batch 128, 4 iterations a stage), ``paged_admit_probe`` (16 slots,
   p2048, 16 new tokens, one timed admit) and
   ``engine_cpu_ratio`` (``block_main_b4_5``, 16 slots); finite figures
   asserted, each cut and each probe's seconds logged.
17. runs the port's benchmark (``phase_bench``): ``bench.main`` at
   ``block_main_b4_1.2b`` against ``vanilla_410``, B = 16, p2048/d128,
   INT8 weights and KV, with the engine (16 slots, both its rows),
   ``BT_BENCH_REPS`` = 2, the stage decomposition's ``ITERS`` cut to 16,
   the detail written to ``build/BENCH_DETAIL.json``,
   in a launch window of its own (K1, W8A8, K2 INT8, K2 bf16 by its warp
   route, K3 and the fused K5 launched; K4 and the paged kernels not); it
   asserts the JSON line's metric (the JAX benchmark's string for this
   command line), finite positive ``value`` and ``vs_baseline``, the
   detail's keys (the stage decomposition at B = 16 among them) and every
   engine request of every rep served its 128 tokens; the line, the detail
   and the phase's seconds logged.

Every timed full-width run of steps 5-9 asserts that W8A8-q and W8A8-mm
launched once for each INT8 linear that took W8A8 and K1 once for each
other one (the baseline: its 96 prefill linears at M = 16384 by W8A8),
that K1, K3 and K4 launched by the tensor-core route only (in float32 on
``eval entry`` and ``eval entry int4``: K3 by ``tf32x3``, K1 and K4 by
``tf32x2``) and W8A8-mm by its wgmma
route only, and every one with a token decoder that K2's bf16
form took the warp route there (its split route runs only on the bf16
global cache). The INT8-weight INT8-cache generation, the baseline and
the INT8 and paged engines each run once more under torch.profiler, and
one JSON line gives each run's device launches (every kernel, copy and
fill) and busy seconds (``device_launches_per_run``). The last three lines
are
the ``nvidia-smi`` line, a JSON object listing each kernel's launches (from
the run of step 5, 6, 7, 8, 11 or 14 named by the row's ``path``; a K6 or K8 row
counts the launches on its pool width, and a K2 bf16 row gives those of its
own route as ``route_launches``), error and times, and
``{"ok": true, "device": {...}}``.
Any failure raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from block_transformer_tpu_torch import bench  # noqa: E402
from block_transformer_tpu_torch import config  # noqa: E402
from block_transformer_tpu_torch import config_yaml  # noqa: E402
from block_transformer_tpu_torch import eval_longctx  # noqa: E402
from block_transformer_tpu_torch import eval_zero_shot_task  # noqa: E402
from block_transformer_tpu_torch import export_checkpoint  # noqa: E402
from block_transformer_tpu_torch.data.tokenizer import ByteTokenizer  # noqa: E402
from block_transformer_tpu_torch.eval import adapters as eval_adapters  # noqa: E402
from block_transformer_tpu_torch.eval import harness as eval_harness  # noqa: E402
from block_transformer_tpu_torch.eval import samplers as eval_samplers  # noqa: E402
from block_transformer_tpu_torch.eval import tasks as eval_tasks  # noqa: E402
from block_transformer_tpu_torch.data import native as native_packer  # noqa: E402
from block_transformer_tpu_torch.data import mmap_dataset  # noqa: E402
from block_transformer_tpu_torch.data import packing  # noqa: E402
from block_transformer_tpu_torch import profile_generate as pg  # noqa: E402
from block_transformer_tpu_torch.scripts import bench_packer  # noqa: E402
from block_transformer_tpu_torch.scripts import build_byte_corpus  # noqa: E402
from block_transformer_tpu_torch.scripts import decode_gate  # noqa: E402
from block_transformer_tpu_torch.scripts import engine_cpu_ratio  # noqa: E402
from block_transformer_tpu_torch.scripts import int4kv_probe  # noqa: E402
from block_transformer_tpu_torch.scripts import kernel_microbench  # noqa: E402
from block_transformer_tpu_torch.scripts import mixed48_stage_probe  # noqa: E402
from block_transformer_tpu_torch.scripts import paged_admit_probe  # noqa: E402
from block_transformer_tpu_torch.scripts import prefill_profile  # noqa: E402
from block_transformer_tpu_torch.scripts import gptq_gate  # noqa: E402
from block_transformer_tpu_torch.scripts import inference_demo  # noqa: E402
from block_transformer_tpu_torch.scripts import kv_quality_cpu  # noqa: E402
from block_transformer_tpu_torch.scripts import kv_scheme_probe  # noqa: E402
from block_transformer_tpu_torch.scripts import longctx_85m  # noqa: E402
from block_transformer_tpu_torch.scripts import longctx_quality_cpu  # noqa: E402
from block_transformer_tpu_torch.scripts import measure_generation_time  # noqa: E402
from block_transformer_tpu_torch.scripts import qat_finetune  # noqa: E402
from block_transformer_tpu_torch.scripts import qat_ppl_gate  # noqa: E402
from block_transformer_tpu_torch.scripts import quality_run  # noqa: E402
from block_transformer_tpu_torch.scripts import real_task_eval  # noqa: E402
from block_transformer_tpu_torch.scripts import train_ckpt  # noqa: E402
from block_transformer_tpu_torch.scripts import train_mfu  # noqa: E402
from block_transformer_tpu_torch.scripts import w8a8_decode_gate  # noqa: E402
from block_transformer_tpu_torch.scripts import w8a8_probe  # noqa: E402
from block_transformer_tpu_torch.scripts import w8a8_probe2  # noqa: E402
from block_transformer_tpu_torch.scripts import w8a8_probe3  # noqa: E402
from block_transformer_tpu_torch.config import NeoXConfig  # noqa: E402
from block_transformer_tpu_torch.inference import generate as gen  # noqa: E402
from block_transformer_tpu_torch.kernels import build  # noqa: E402
from block_transformer_tpu_torch.kernels import decode_attention as k2  # noqa: E402
from block_transformer_tpu_torch.kernels import dequant_matmul as k1  # noqa: E402
from block_transformer_tpu_torch.kernels import flash_attention as k3  # noqa: E402
from block_transformer_tpu_torch.kernels import paged_attention as kp  # noqa: E402
from block_transformer_tpu_torch.kernels import w8a8  # noqa: E402
from block_transformer_tpu_torch.models import block_transformer as bt  # noqa: E402
from block_transformer_tpu_torch.models import embedder as emb  # noqa: E402
from block_transformer_tpu_torch.models import neox  # noqa: E402
from block_transformer_tpu_torch.models import vanilla  # noqa: E402
from block_transformer_tpu_torch.ops import linear as linear_ops  # noqa: E402
from block_transformer_tpu_torch.ops import masks  # noqa: E402
from block_transformer_tpu_torch.ops import gptq  # noqa: E402
from block_transformer_tpu_torch.ops import quant  # noqa: E402
from block_transformer_tpu_torch.train import optimizer as opt  # noqa: E402
from block_transformer_tpu_torch.train import train_step as ts  # noqa: E402
from block_transformer_tpu_torch.train import trainer as trainer_lib  # noqa: E402
from block_transformer_tpu_torch.utils import checkpoint as ckpt  # noqa: E402
from block_transformer_tpu_torch.utils import hbm  # noqa: E402
from block_transformer_tpu_torch.utils import profiling  # noqa: E402
from block_transformer_tpu_torch.utils import roofline  # noqa: E402
from block_transformer_tpu_torch.utils import torch_export  # noqa: E402
from block_transformer_tpu_torch.utils import torch_import  # noqa: E402

# H100 SXM data-sheet peaks (dense): HBM bytes/s, bf16 tensor-core FLOP/s and
# int8 tensor-core operations/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
INT8_OPS = 1979e12
FP32_FLOPS = 67e12      # float32 outside the tensor cores
# float32 products on the TF32 tensor cores three times over (K3's tf32x3
# route): a third of the 495 TFLOP/s TF32 rate; twice over (K1/K4's
# tf32x2 route: x split, the integer weights exact): half of it
TF32X3_FLOPS = 495e12 / 3
TF32X2_FLOPS = 495e12 / 2
# float32 attention is bounded at TF32X3_FLOPS whatever route runs: the
# card computes it float32-accurate at that rate (K3's CUDA-core "fma"
# route and K2's float32 cache included), not at FP32_FLOPS
# the fastest exact rate for float32 x times INT8 / INT4 weights, K1/K4's
# float32 bound: the weights are exact in bf16 and x in three bf16 parts
# (3 x 8 significant bits), so three bf16 passes, a third of 989 TFLOP/s
F32_X_INT_FLOPS = BF16_FLOPS / 3
TOL = 2e-2      # max |kernel - plain| / max |plain| in bf16 (~2^-8 rounding
                # of outputs and probabilities, summed in another order)

MODEL, VANILLA_MODEL, BATCH = pg.MODEL, pg.VANILLA_MODEL, pg.BATCH
GROUP_SIZE = pg.GROUP_SIZE
CARD = "cuda"
PROMPT_TOKENS, NEW_TOKENS = pg.PROMPT_TOKENS, pg.NEW_TOKENS
MATMUL_CU = "block_transformer_tpu_torch/csrc/dequant_matmul.cu"
DECODE_CU = "block_transformer_tpu_torch/csrc/decode_attention.cu"
DECODE_PY = "block_transformer_tpu/ops/decode_attention.py"
PAGED_CU = "block_transformer_tpu_torch/csrc/paged_attention.cu"
PAGED_PY = "block_transformer_tpu/ops/paged_attention.py"
W8A8_CU = "block_transformer_tpu_torch/csrc/w8a8.cu"
# not a TPU kernel: XLA ops in the JAX package (_w8a8_dot)
W8A8_JAX = "block_transformer_tpu/ops/linear.py:219"
# the shipped ablation YAMLs the families phase runs
FAMILY_NAMES = ("block_megabyte_b4_85", "block_ablation_b4_85_cls_cross_attn",
                "block_uniform_b4_85", "block_ablation_b4_85_roberta_prefix")
ROOT = os.path.dirname(os.path.abspath(__file__))


def config_path(name: str) -> str:
    return os.path.join(ROOT, "configs", f"{name}.yaml")


def family_config(name: str) -> config.BlockTransformerConfig:
    """``configs/<name>.yaml`` through the port's loader."""
    return config_yaml.load_block_config_yaml(config_path(name))


# (wrapper, tag, source, TPU kernel replaced, the run whose launches count,
# the pool width whose launches a K6/K8 row counts, else None: all)
KERNELS = [
    (k1.int8_matmul_stacked, "K1", MATMUL_CU,
     "block_transformer_tpu/ops/dequant_matmul.py:86", "generation", None),
    (k2.decode_attention_int8_stacked, "K2", DECODE_CU, f"{DECODE_PY}:143",
     "generation", None),
    (k2.decode_attention_stacked, "K2 bf16", DECODE_CU, f"{DECODE_PY}:293",
     "generation kv bf16", None),
    (k3.flash_attention, "K3", "block_transformer_tpu_torch/csrc/flash_attention.cu",
     "block_transformer_tpu/ops/flash_attention.py:83", "generation", None),
    (k1.int4_matmul_stacked, "K4", MATMUL_CU,
     "block_transformer_tpu/ops/dequant_matmul.py:181", "generation int4",
     None),
    (kp.paged_write_int8, "K5", PAGED_CU, f"{PAGED_PY}:428", "engine int8",
     None),
    (kp.paged_decode_attention_int8, "K6", PAGED_CU, f"{PAGED_PY}:221",
     "engine paged", "int8"),
    (kp.paged_decode_attention_int8, "K6 int4", PAGED_CU, f"{PAGED_PY}:221",
     "engine paged-int4", "int4"),
    (kp.paged_write_layers_int8, "K7", PAGED_CU, f"{PAGED_PY}:549",
     "engine paged", None),
    (kp.paged_page_copy_int8, "K8", PAGED_CU, f"{PAGED_PY}:646",
     "engine paged", "int8"),
    (kp.paged_page_copy_int8, "K8 int4", PAGED_CU, f"{PAGED_PY}:646",
     "engine paged-int4", "int4"),
    # K5 and K7 fused with the INT8 KV quantization; they replace K5 and K7
    # on every main path, whose rows above then count no launch (OFF_PATH)
    (kp.paged_quantize_write_int8, "K5 fused", PAGED_CU, f"{PAGED_PY}:428",
     "engine int8", None),
    (kp.paged_quantize_step_int8, "K7 step", PAGED_CU, f"{PAGED_PY}:549",
     "engine paged", None),
    (kp.paged_quantize_write_layers_int8, "K7 fused", PAGED_CU,
     f"{PAGED_PY}:549", "engine paged", None),
    (w8a8.w8a8_quant, "W8A8-q", W8A8_CU, W8A8_JAX, "generation", None),
    (w8a8.w8a8_matmul_stacked, "W8A8-mm", W8A8_CU, W8A8_JAX, "generation",
     None),
]
W8A8 = ("W8A8-q", "W8A8-mm")
K5_FUSED = ("K5 fused",)   # the INT8 cache's decode write
K7_FUSED = ("K7 step", "K7 fused")   # the paged INT8 pool's
# K5's and K7's own kernels keep JAX's signatures and run on no main path
OFF_PATH = ("K5", "K7")
# the kernels each main path must launch; every path with a token decoder
# runs K2's bf16 form on its local cache
PATH_KERNELS = {
    "generation": ("K1", "K2", "K2 bf16", "K3", *K5_FUSED, *W8A8),
    "generation streaming": ("K1", "K2", "K2 bf16", "K3", *K5_FUSED),
    "generation int4": ("K2", "K2 bf16", "K3", "K4", *K5_FUSED),
    "generation mixed48": ("K1", "K2", "K2 bf16", "K3", "K4", *K5_FUSED,
                           *W8A8),
    "generation kv bf16": ("K1", "K2 bf16", "K3", *W8A8),
    "generation kv int4": ("K1", "K2 bf16", "K3", *W8A8),
    "engine int8": ("K1", "K2", "K2 bf16", "K3", *K5_FUSED, *W8A8),
    "engine int4": ("K1", "K2 bf16", "K3", *W8A8),
    "engine paged": ("K1", "K2 bf16", "K3", "K6", *K7_FUSED, "K8", *W8A8),
    "engine paged-int4": ("K1", "K2 bf16", "K3", "K6 int4", "K8 int4",
                          *W8A8),
    "vanilla": ("K1", "K2", "K3", *K5_FUSED, *W8A8),
    # evaluation (phase_eval): scoring is a teacher-forced forward; the
    # generation tasks' prompts fill a bf16 global cache
    "eval score": ("K3", *W8A8),
    "eval entry": ("K3", *W8A8),
    "eval entry int4": ("K3", "K4"),
    "eval generate": ("K1", "K2 bf16", "K3", *W8A8),
    "eval vanilla": ("K3", *W8A8),
    "eval longctx ppl": ("K3",),
    "eval longctx needle": ("K2 bf16", "K3"),
}
SERVING = (*K5_FUSED, "K6", "K6 int4", *K7_FUSED, "K8", "K8 int4")
# the kernels a main path must not launch: INT4 weights leave K1 no linear;
# the INT4 and bf16 caches take no INT8 cache kernel; the baseline has no
# bf16 cache
PATH_ABSENT = {
    "generation streaming": W8A8,   # chunks of M = 1024 < 2048 (INT8 KV)
    "generation int4": ("K1", *W8A8),
    "generation kv bf16": ("K2", *K5_FUSED),
    "generation kv int4": ("K2", *K5_FUSED),
    "engine int8": K7_FUSED,
    "engine int4": ("K2", *K5_FUSED, "K6", "K6 int4"),
    "engine paged": ("K6 int4", "K8 int4"),
    "engine paged-int4": ("K2", *K5_FUSED, "K6", *K7_FUSED, "K8"),
    "vanilla": ("K2 bf16",),
    "eval score": ("K2", "K2 bf16", "K4", *SERVING),
    "eval entry": ("K2", "K2 bf16", "K4", *SERVING),
    "eval entry int4": ("K1", "K2", "K2 bf16", *W8A8, *SERVING),
    "eval generate": ("K2", "K4", *SERVING),
    "eval vanilla": ("K2", "K2 bf16", "K4", *SERVING),
    "eval longctx ppl": ("K1", "K2", "K2 bf16", "K4", *W8A8, *SERVING),
    "eval longctx needle": ("K1", "K2", "K4", *W8A8, *SERVING),
}
# the paths whose bf16 global cache (capacity > 32) takes K2 bf16's split
# route; every other path runs it on the token decoder's local cache alone
# the paths that run K2 bf16 with no token decoder (a vanilla bf16 cache):
# no warp route
K2_NO_LOCAL_CACHE = ()
K2_SPLIT_PATHS = ("generation kv bf16", "eval generate",
                  "eval longctx needle")


def family_path(name: str) -> str:
    return f"family {name}"


def add_family_path(name: str, prefix: bool) -> str:
    """Register an ablation family's run (INT8 weights and global cache) in
    PATH_KERNELS / PATH_ABSENT: K2's bf16 form serves the local cache of
    the prefix decoders; the re-run decoders keep no cache; no INT4
    weights. Returns the path's name."""
    path = family_path(name)
    PATH_KERNELS[path] = ("K1", "K2", "K3", *W8A8) + (
        ("K2 bf16",) if prefix else ())
    PATH_ABSENT[path] = ("K4",) + (() if prefix else ("K2 bf16",))
    return path
# K1, K3, K4 and W8A8-mm count their launches by route as well; a
# full-width path takes the route named here only: the tensor cores ("tc")
# for K1, K3 and K4, wgmma fed by TMA for W8A8-mm
ROUTED = {"K1": (k1.int8_matmul_stacked, "tc"),
          "K3": (k3.flash_attention, "tc"),
          "K4": (k1.int4_matmul_stacked, "tc"),
          "W8A8-mm": (w8a8.w8a8_matmul_stacked, "wgmma")}
# the paths that take another route than ROUTED's: the eval entry point
# scores float32 activations, which K1 and K4 take by their TF32 route (x
# split in two) and K3 by its float32 tensor-core route (3xTF32)
PATH_ROUTES = {"eval entry": {"K1": "tf32x2", "K3": "tf32x3"},
               "eval entry int4": {"K3": "tf32x3", "K4": "tf32x2"}}


def log(msg: str) -> None:
    print(msg, flush=True)


def kernel_label(line: str) -> str:
    """A short name for ptxas's mangled entry function: the kernel's name,
    its element type and its integer and bool template arguments, e.g.
    tc_matmul_kernel<16,128,32,16,16,6,3,0>, int8_matmul_kernel<f32,4> or
    flash_attn_tc_kernel<f32,128,4,1,32> (the tile's type, then its ints)."""
    mangled = line.split("'")[1] if "'" in line else line
    m = re.search(r"_cu_[0-9a-f]{8}\d+(\w+?_kernel)I(.*?)EEv", mangled)
    if m is None:
        return mangled[-40:]
    args = m.group(2)
    kind = ("f32" if args.startswith("f") or "IfL" in args else
            "bf16" if args.startswith("13__nv_bfloat16")
            or "I13__nv_bfloat16" in args else None)
    return m.group(1) + "<" + ",".join(
        ([kind] if kind else []) + re.findall(r"L[ib](\d+)E", args)) + ">"


SPIN_CYCLES = 20_000_000   # ~10 ms at the H100's top SM clock
SM_HZ = 1.98e9
retimed = []                # the windows queued slower than their spin


def time_ms_host(fn, iters: int):
    """(mean device ms, mean host us) of ``fn`` over ``iters`` calls. The
    device first spins for ~10 ms, so the host has queued the calls before
    the device reaches them: the CUDA events time the device's work alone,
    unless ``fn`` itself waits for the device, and the host clock times
    the calls' host cost. A window whose calls took the host longer than
    the spin (the device then waited for the host between them) is timed
    once more behind a spin twice that long."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    spin = SPIN_CYCLES
    for _ in range(2):
        torch.cuda._sleep(spin)                # clock cycles
        start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        window = time.perf_counter() - t0
        end.record()
        end.synchronize()
        if window * SM_HZ < spin:
            break
        retimed.append(window)
        spin = int(2 * window * SM_HZ)
    return start.elapsed_time(end) / iters, window / iters * 1e6


def time_ms(fn, iters: int) -> float:
    return time_ms_host(fn, iters)[0]


def bound(nbytes: float, flops: float, peak: float = BF16_FLOPS):
    """(ms, "bytes" or "operations"): the larger of nbytes over the memory
    rate and flops over ``peak`` (the bf16 tensor-core rate by default)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def attention_need(mask: masks.AttnMask, H: int, D: int, B: int = 1):
    """What masked attention needs on this mask's data for B batch rows,
    summed over heads: (key rows read, value rows read, operations). A key
    is read when some query of its batch row may see it; a query with no
    allowed key takes the uniform mean of all values, so its batch row
    reads every value."""
    allowed = mask.allowed()                   # [B, Q, K] (B = 1: shared)
    allowed = allowed.expand(max(B, allowed.shape[0]), -1, -1)
    K = allowed.shape[-1]
    seen = allowed.any(1)                      # [B, K]
    empty = ~allowed.any(-1)                   # [B, Q]
    k_rows = seen.sum().item()
    v_rows = torch.where(empty.any(-1), K, seen.sum(-1)).sum().item()
    ops = 4 * D * allowed.sum().item() + D * K * empty.sum().item()
    return H * k_rows, H * v_rows, H * ops


def compare(name: str, got: torch.Tensor, want: torch.Tensor,
            tol: float = TOL):
    """(max |kernel - plain|, max|plain|); fails past ``tol`` * max|plain|."""
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: kernel output is not finite")
    err = (got.float() - want.float()).abs().max().item()
    scale = abs_max(want)
    if err > tol * scale:
        raise AssertionError(f"{name}: max |kernel - plain| {err:.3e} > "
                             f"{tol} * max|plain| {scale:.3e}")
    return err, scale


def abs_max(*ts) -> float:
    """The largest magnitude in the tensors ``ts``."""
    return max(t.float().abs().max().item() for t in ts)


def record(rows, tag, label, err, ms, plain_ms, library_ms, nbytes, flops,
           plan=None, host_us=None, extra=None, path=None, peak=BF16_FLOPS,
           plain_max=None):
    """One kernel row of the kernel ``tag`` in KERNELS; ``plan`` (K1, K4) is
    the dequant-matmul's launch, ``host_us`` the wrapper's host time a call,
    ``extra`` more keys (K2's split, K3's route), ``path`` the main path
    whose launches the row reports (by default the kernel's own in
    KERNELS), ``plain_max`` the plain version's largest magnitude, which
    ``err`` is held against (None for a row held bit for bit)."""
    fn, _, source, replaces, own_path, _ = next(k for k in KERNELS
                                                if k[1] == tag)
    bound_ms, bound_by = bound(nbytes, flops, peak)
    row = {"name": f"{tag} {fn.__name__} [{label}]", "tag": tag,
           "route": "cuda",
           "path": path or own_path, "source": source, "replaces": replaces, "launches": None,
           "max_abs_err": err, "max_abs_plain": plain_max, "ms": ms,
           "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": library_ms}
    row.update(extra or {})
    note = "".join(f", {k} {v}" for k, v in (extra or {}).items())
    if plan is not None:
        row["matmul_route"] = (f"{plan.route} {'x'.join(map(str, plan.tile))}"
                               f" splits {plan.splits}")
        note += f", route {row['matmul_route']}"
    if host_us is not None:
        row["host_us"] = host_us
        note += f", host {host_us:.1f} us/call"
    rows.append(row)
    lib = "none" if library_ms is None else f"{library_ms:.5f} ms"
    held = ("bit-exact" if plain_max is None
            else f"max|plain| {plain_max:.3e}")
    log(f"{tag} [{label}]: kernel {ms:.5f} ms, plain {plain_ms:.5f} ms, "
        f"library {lib}, bound {bound_ms:.5f} ms ({bound_by}), "
        f"max_abs_err {err:.3e} ({held}){note}")


def matmul_plan(M, K, N, dtype=torch.bfloat16, group=0):
    """K1's / K4's launch plan for x of ``dtype`` on this card (K: packed
    rows for K4, ``group`` its rows a scale group)."""
    return k1.plan(M, K, N, dtype, build.sm_count(0), group=group)


def matmul_fma(name, x, w, scale, layer, ints):
    """K1's or K4's CUDA-core kernel (``name`` "int8_matmul" or
    "int4_matmul") through the C entry with the "fma" route code, whatever
    ``plan`` would take: a yardstick, not counted as a launch. ``ints``: the
    C entry's (K, N) or (Kh, N, gs)."""
    out = torch.empty((x.shape[0], w.shape[2]), dtype=x.dtype,
                      device=x.device)
    p = k1.fma_plan(x.shape[0], w.shape[1], w.shape[2], build.sm_count(0))
    k1.launch_plan(name, p, k1.layer_pointers(x, w, scale, layer, out),
                   x.shape[0], ints, x.dtype, 0)
    return out


# max |kernel - plain| / max|plain| of K1's and K4's float32 route: x split
# into two TF32 halves over exact integer weights keeps ~2^-22 of each
# product, summed in short chains joined by rounded float32 adds (a torch
# model of it: <= 7.2e-7 against JAX's kernels, tests/test_torch_matmul_
# tf32.py); one TF32 pass keeps ~2^-11 (1.5-2.2e-4 in that model), which
# bf16's TOL would pass and this refuses
K14_F32_TOL = 1e-5


def k1_row(rows, g, label, M, K, N, layers, path=None,
           dtype=torch.bfloat16):
    """K1 at x [M, K] @ an INT8 [layers, K, N] stack against its plain
    version and ``torch.matmul`` on the dequantized layer, cycling through
    the layers so the weights come from device memory, as in the layer
    loop, not from L2; x in ``dtype`` (float32: the TF32 route, held within
    K14_F32_TOL, beside the CUDA-core kernel at the same inputs as
    ``fma_ms``)."""
    dev = CARD
    f32 = dtype == torch.float32
    w_q, scale = quant.quantize_int8(torch.randn((layers, K, N), generator=g,
                                                 device=dev, dtype=dtype)
                                     * 0.02)
    x = torch.randn((M, K), generator=g, device=dev, dtype=dtype)
    w_deq = [quant.dequantize_int8(w_q[i], scale[i], dtype)
             for i in range(layers)]
    p = matmul_plan(M, K, N, dtype)
    before = dict(k1.int8_matmul_stacked.route_launches)
    got = k1.int8_matmul_stacked(x, w_q, scale, layers - 1)
    if routes_since(k1.int8_matmul_stacked, before)[p.route] != 1:
        raise AssertionError(f"K1 {label}: not the {p.route} route")
    want = k1.int8_matmul_stacked_plain(x, w_q, scale, layers - 1)
    tol = K14_F32_TOL if f32 else TOL
    err, pmax = compare(f"K1 {label}", got, want, tol)
    it = iter(range(10 ** 9))
    nxt = lambda: next(it) % layers          # noqa: E731
    iters = 10 if M > 64 else 60
    extra = {}
    if f32:
        ints = (K, N)
        extra["fma_max_abs_err"], _ = compare(
            f"K1 {label} fma", matmul_fma("int8_matmul", x, w_q, scale,
                                          layers - 1, ints), want, tol)
        extra["fma_ms"] = time_ms(lambda: matmul_fma(
            "int8_matmul", x, w_q, scale, nxt(), ints), iters)
        extra["allow_tf32"] = torch.backends.cuda.matmul.allow_tf32
    del got, want
    ms, host_us = time_ms_host(
        lambda: k1.int8_matmul_stacked(x, w_q, scale, nxt()), iters)
    plain_ms = time_ms(lambda: k1.int8_matmul_stacked_plain(
        x, w_q, scale, nxt()), iters)
    lib_ms = time_ms(lambda: torch.matmul(x, w_deq[nxt()]), iters)
    size = x.element_size()
    nbytes = M * K * size + K * N + N * 4 + M * N * size
    if f32:     # the bound of the route's own two TF32 passes, beside
        extra["tf32x2_bound_ms"] = bound(nbytes, 2 * M * K * N,
                                         TF32X2_FLOPS)[0]
    record(rows, "K1", label, err, ms, plain_ms, lib_ms,
           nbytes, 2 * M * K * N, p, host_us, path=path,
           peak=F32_X_INT_FLOPS if f32 else BF16_FLOPS, plain_max=pmax,
           extra=extra)


def phase_k1(rows, cfg):
    """K1 at the main path's shapes, each over a 12-layer stack (the head
    over one layer)."""
    g = torch.Generator(device="cuda").manual_seed(1)
    h, m, L = cfg.block_decoder.hidden_size, cfg.block_decoder.intermediate_size, 12
    V = cfg.vocab_size
    shapes = [("qkv M=8", 8, h, 3 * h, L), ("mlp_down M=8", 8, m, h, L),
              ("lm_head M=8", 8, h, V, 1), ("qkv M=32", 32, h, 3 * h, L),
              ("qkv M=4096", 4096, h, 3 * h, L)]
    for label, M, K, N, layers in shapes:
        k1_row(rows, g, label, M, K, N, layers)


def phase_k4(rows, cfg):
    """K4 at the INT4 path's shapes (group size 128), cycling through a
    12-layer stack as ``phase_k1`` does."""
    dev, bf16 = "cuda", torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(4)
    h, m, L = cfg.block_decoder.hidden_size, cfg.block_decoder.intermediate_size, 12
    V = cfg.vocab_size
    shapes = [("qkv M=8", 8, h, 3 * h, L), ("mlp_down M=8", 8, m, h, L),
              ("lm_head M=8", 8, h, V, 1), ("qkv M=32", 32, h, 3 * h, L),
              ("qkv M=4096", 4096, h, 3 * h, L)]
    for label, M, K, N, layers in shapes:
        w_p, scale = quant.quantize_int4(
            torch.randn((layers, K, N), generator=g, device=dev, dtype=bf16)
            * 0.02, pg.GROUP_SIZE)
        G = scale.shape[1]
        x = torch.randn((M, K), generator=g, device=dev, dtype=bf16)
        w_deq = [quant.dequantize_int4(w_p[i], scale[i], bf16)
                 for i in range(layers)]
        got = k1.int4_matmul_stacked(x, w_p, scale, layers - 1)
        want = k1.int4_matmul_stacked_plain(x, w_p, scale, layers - 1)
        err, pmax = compare(f"K4 {label}", got, want)
        it = iter(range(10 ** 9))
        nxt = lambda: next(it) % layers          # noqa: E731
        iters = 10 if M > 64 else 60
        ms, host_us = time_ms_host(
            lambda: k1.int4_matmul_stacked(x, w_p, scale, nxt()), iters)
        plain_ms = time_ms(lambda: k1.int4_matmul_stacked_plain(
            x, w_p, scale, nxt()), iters)
        lib_ms = time_ms(lambda: torch.matmul(x, w_deq[nxt()]), iters)
        nbytes = M * K * 2 + K * N // 2 + G * N * 4 + M * N * 2
        record(rows, "K4", f"{label} G={G}", err, ms,
               plain_ms, lib_ms, nbytes, 2 * M * K * N,
               matmul_plan(M, K // 2, N), host_us, plain_max=pmax)
        del w_p, scale, w_deq


def exact_pair(name, got, want) -> None:
    """Bit for bit, as the W8A8 kernels must be."""
    for a, b in zip(got, want):
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError(f"{name}: kernel and plain differ")


def int_mm_ms(xq, w_q, nxt):
    """(ms, layout) of ``torch._int_mm(xq, w_q[layer])`` cycling through the
    layers (M > 16, K and N multiples of 8): the faster of the row-major
    weights as they are and a column-major copy, each where the library
    takes it."""
    best = None
    for layout in ("row-major", "column-major"):
        ws = [w if layout == "row-major" else w.t().contiguous().t()
              for w in w_q]
        try:
            torch._int_mm(xq, ws[0])
        except RuntimeError as e:                  # a layout it refuses
            log(f"torch._int_mm refuses {layout} weights: {e}")
            continue
        ms = time_ms(lambda: torch._int_mm(xq, ws[nxt()]), 20)
        if best is None or ms < best[0]:
            best = (ms, layout)
    if best is None:
        raise AssertionError("torch._int_mm takes neither layout")
    return best


def w8a8_pair(x, w_q, scale, layer):
    xq, sx = w8a8.w8a8_quant(x)
    return w8a8.w8a8_matmul_stacked(xq, sx, w_q, scale, layer, x.dtype)


def w8a8_rows(rows, g, label, M, K, N, L, path, dtype=torch.bfloat16):
    """W8A8-q and W8A8-mm at x [M, K] (``dtype``, bf16 by default; the
    output in it too) @ an INT8 [L, K, N] stack: each bit-exact against
    its plain version and timed beside it, beside ``torch._int_mm``
    (W8A8-mm's library yardstick; W8A8-q has none) and beside K1 at the
    same shape, cycling through the layers. Returns (x, w_q, scale, the
    layer cycler)."""
    dev, bf16 = "cuda", torch.bfloat16
    w_q, scale = quant.quantize_int8(torch.randn(
        (L, K, N), generator=g, device=dev, dtype=bf16) * 0.02)
    x = torch.randn((M, K), generator=g, device=dev, dtype=dtype)
    xq, sx = w8a8.w8a8_quant(x)
    want = w8a8.w8a8_quant_plain(x)
    exact_pair(f"W8A8-q {label}", (xq, sx), want)
    got = w8a8.w8a8_matmul_stacked(xq, sx, w_q, scale, L - 1, dtype)
    want = w8a8.w8a8_matmul_stacked_plain(xq, sx, w_q, scale, L - 1, dtype)
    exact_pair(f"W8A8-mm {label}", (got,), (want,))
    mm_max = abs_max(want)
    del got, want
    it = iter(range(10 ** 9))
    nxt = lambda: next(it) % L             # noqa: E731
    q_ms = time_ms(lambda: w8a8.w8a8_quant(x), 20)
    q_plain = time_ms(lambda: w8a8.w8a8_quant_plain(x), 5)
    mm_ms, mm_host_us = time_ms_host(lambda: w8a8.w8a8_matmul_stacked(
        xq, sx, w_q, scale, nxt(), dtype), 20)
    mm_plain = time_ms(lambda: w8a8.w8a8_matmul_stacked_plain(
        xq, sx, w_q, scale, nxt(), dtype), 3)
    lib_ms, layout = int_mm_ms(xq, w_q, nxt)
    # K1 beside it (float32 x: its TF32 route)
    k1_ms = time_ms(lambda: k1.int8_matmul_stacked(x, w_q, scale, nxt()),
                    10)
    extra = {"k1_ms": k1_ms, "pair_ms": q_ms + mm_ms}
    size = x.element_size()
    record(rows, "W8A8-q", f"{label} M={M} K={K}", 0.0, q_ms, q_plain,
           None, M * K * size + M * K + M * 4, 0, path=path, extra=extra,
           plain_max=None)
    p = w8a8.plan(M, K, N, build.sm_count(0))
    record(rows, "W8A8-mm", f"{label} M={M} K={K} N={N}", 0.0, mm_ms,
           mm_plain, lib_ms, M * K + K * N + M * 4 + N * 4 + M * N * size,
           2 * M * K * N, path=path, peak=INT8_OPS, host_us=mm_host_us,
           plain_max=mm_max,
           extra={**extra, "w8a8_plan": (
                      f"{p.route} {'x'.join(map(str, p.tile))} splits "
                      f"{p.splits} blocks {p.blocks}"),
                  "int8_peak_share": 2 * M * K * N / INT8_OPS
                  / (mm_ms * 1e-3),
                  "int_mm_layout": layout})
    return x, w_q, scale, nxt


def phase_w8a8(rows, cfg, vcfg, smi):
    """W8A8-q and W8A8-mm (``w8a8_rows``) at the prefill's linears over a
    12-layer stack: the block decoder's (M = B x 512 prompt blocks = 4096:
    qkv, attn-out, mlp-up, mlp-down) and the baseline's qkv (M = 8 x 2048
    = 16384). Then the crossover on the block decoder's four shapes: the
    W8A8 pair against K1 at M from 256 to 4096, printed as one JSON line
    with the card."""
    g = torch.Generator(device="cuda").manual_seed(13)
    h, m = cfg.block_decoder.hidden_size, cfg.block_decoder.intermediate_size
    vh, L = vcfg.hidden_size, 12
    Mb = BATCH * PROMPT_TOKENS // cfg.block_length * cfg.n_embedding_tokens
    shapes = [("qkv", Mb, h, 3 * h, "generation"),
              ("attn_out", Mb, h, h, "generation"),
              ("mlp_up", Mb, h, m, "generation"),
              ("mlp_down", Mb, m, h, "generation"),
              ("baseline qkv", BATCH * PROMPT_TOKENS, vh, 3 * vh, "vanilla")]
    crossover = []
    for label, M, K, N, path in shapes:
        x, w_q, scale, nxt = w8a8_rows(rows, g, label, M, K, N, L, path)
        if path == "generation":
            for Mc in (256, 384, 512, 1024, 2048, 4096):
                xc = x[:Mc]
                crossover.append({
                    "shape": label, "M": Mc, "K": K, "N": N,
                    "k1_ms": time_ms(lambda: k1.int8_matmul_stacked(
                        xc, w_q, scale, nxt()), 10),
                    "w8a8_ms": time_ms(lambda: w8a8_pair(
                        xc, w_q, scale, nxt()), 10)})
        del w_q, scale, x
    log(json.dumps({"w8a8_crossover": crossover, "card": smi}))


def int8_layers(g, L, B, H, cap, D):
    """A random L-layer INT8 cache, quantized as the model writes it:
    (k int8, k_scale, v int8, v_scale)."""
    kv = torch.randn((2, L, B, H, cap, D), generator=g, device="cuda")
    kq, ks = quant.quantize_kv(kv[0].reshape(L * B, H, cap, D))
    vq, vs = quant.quantize_kv(kv[1].reshape(L * B, H, cap, D))
    return (kq.reshape(L, B, H, cap, D), ks.reshape(L, B, H, cap),
            vq.reshape(L, B, H, cap, D), vs.reshape(L, B, H, cap))


def k2_row(rows, label, cache, q, mask, iters, path=None, tol=TOL):
    """K2 against its plain version (within ``tol`` of max|plain|) and SDPA
    on the cache's layers in q's dtype (dequantized for the INT8 form),
    cycling through the layers so they come from device memory. ``cache``:
    (k_q, k_s, v_q, v_s) for the INT8 form, (k, v) in bf16 or float32 for
    the bf16 form."""
    int8 = len(cache) == 4
    tag = "K2" if int8 else "K2 bf16"
    fn, plain = ((k2.decode_attention_int8_stacked,
                  k2.decode_attention_int8_stacked_plain) if int8 else
                 (k2.decode_attention_stacked,
                  k2.decode_attention_stacked_plain))
    L, B, H, cap, _ = cache[0].shape
    S, D = q.shape[2], q.shape[3]
    route = k2.route(cap, S, D, cache[0].dtype)
    before = dict(k2.decode_attention_stacked.route_launches)
    got = fn(q, *cache, L // 2, mask)
    if not int8 and (k2.decode_attention_stacked.route_launches[route]
                     != before[route] + 1):
        raise AssertionError(f"{tag} {label}: not the {route} route")
    err, pmax = compare(f"{tag} {label}", got,
                        plain(q, *cache, L // 2, mask), tol)
    it = iter(range(10 ** 9))
    nxt = lambda: next(it) % L                 # noqa: E731
    ms = time_ms(lambda: fn(q, *cache, nxt(), mask), iters)
    plain_ms = time_ms(lambda: plain(q, *cache, nxt(), mask), 10)
    if int8:
        kq, ks, vq, vs = cache
        layers = [(quant.dequantize_kv(kq[i], ks[i], q.dtype),
                   quant.dequantize_kv(vq[i], vs[i], q.dtype))
                  for i in range(L)]
    else:
        layers = list(zip(*cache))
    allowed = mask.allowed()[:, None]          # [B, 1, S, cap]

    def library():
        k, v = layers[nxt()]
        return torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=allowed)

    lib_ms = time_ms(library, iters)
    k_rows, v_rows, ops = attention_need(mask, H, D, B)
    # values (+ scale) of a slot
    row_bytes = D + 4 if int8 else D * cache[0].element_size()
    mask_ints = sum(t.numel() for t in mask if t is not None)
    nbytes = (2 * B * H * S * D * q.element_size()
              + (k_rows + v_rows) * row_bytes
              + mask_ints * 4)
    if route == "warp":
        how = "one warp a (b, h), 4 a block"
    else:
        p = k2.plan(B, H, cap, build.sm_count(0))
        how = f"splits {p.splits} x {p.slots_per_split} slots"
    record(rows, tag, label, err, ms, plain_ms, lib_ms, nbytes, ops,
           path=path, extra={"decode_route": route, "decode_plan": how},
           plain_max=pmax,
           peak=TF32X3_FLOPS if q.dtype == torch.float32 else BF16_FLOPS)
    del layers


def phase_k2(rows, cfg, vcfg, B=BATCH, path=None):
    """K2 at the block decoder's decode step (B rows, 8 by default, H=16,
    S=1, D=128, a 12-layer cache of capacity 640 filled to 530 slots, some
    rows finished, some left-padded) and at the baseline's (H=16, S=1,
    D=64, a 24-layer cache of capacity 2176 filled to 2100); in each, one
    row has no allowed key. ``path``: the main path both rows report (by
    default generation's and the baseline's)."""
    dev, bf16 = "cuda", torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(2)
    H, D = cfg.block_decoder.num_heads, cfg.block_decoder.head_dim
    cap, filled = 640, 530
    cache = int8_layers(g, 12, B, H, cap, D)
    q = torch.randn((B, H, 1, D), generator=g, device=dev, dtype=bf16)
    valid = torch.zeros((B, cap), dtype=torch.int32, device=dev)
    for b in range(B):
        valid[b, 16 * b:filled] = 1           # left pad of 16*b blocks
    valid[B - 2:, filled - 4:filled] = 0       # finished rows
    valid[0] = 0                               # a row with no allowed key
    mask = masks.block_decode_mask(filled - 1, cap, 1, valid)
    k2_row(rows, f"B={B} H={H} S=1 D={D} cap={cap}", cache, q, mask, 100,
           path=path)
    del cache

    H, D = vcfg.num_heads, vcfg.head_dim
    cap, filled = PROMPT_TOKENS + NEW_TOKENS, 2100
    cache = int8_layers(g, vcfg.num_layers, B, H, cap, D)
    q = torch.randn((B, H, 1, D), generator=g, device=dev, dtype=bf16)
    valid = torch.ones((B, cap), dtype=torch.int32, device=dev)
    valid[1] = 0                               # a row with no allowed key
    mask = masks.decode_mask(filled - 1, cap, 1, valid, device=dev)
    k2_row(rows, f"baseline B={B} H={H} S=1 D={D} cap={cap}", cache, q,
           mask, 100, path=path or "vanilla")
    del cache


def phase_k2_bf16(rows, cfg):
    """K2's bf16 form at the block decoder's decode step over a bf16 global
    cache (B=8, H=16, S=1, D=128, 12 layers of capacity 640 filled to 530,
    as ``phase_k2``; one row with no allowed key: the split route) and at
    the token decoder's local cache (B=8, H=16, D=128, 12 layers of
    capacity n_exp + block_length = 6, the token decoder's own mask: the
    warp route), at its last token step (S=1 at position 4) and its prefix
    step (S=n_exp=2 at positions 0-1)."""
    dev, bf16 = "cuda", torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(9)
    B, H, D = BATCH, cfg.block_decoder.num_heads, cfg.block_decoder.head_dim
    cap, filled = 640, 530
    k, v = (torch.randn((12, B, H, cap, D), generator=g, device=dev,
                        dtype=bf16) for _ in range(2))
    q = torch.randn((B, H, 1, D), generator=g, device=dev, dtype=bf16)
    valid = torch.zeros((B, cap), dtype=torch.int32, device=dev)
    for b in range(B):
        valid[b, 16 * b:filled] = 1
    valid[B - 2:, filled - 4:filled] = 0
    valid[0] = 0
    mask = masks.block_decode_mask(filled - 1, cap, 1, valid)
    k2_row(rows, "B=8 H=16 S=1 D=128 cap=640", (k, v), q, mask, 100)
    del k, v

    tcfg = cfg.token_decoder.neox
    H, D, L = tcfg.num_heads, tcfg.head_dim, tcfg.num_layers
    cap = cfg.n_expanded_emb + cfg.block_length
    k, v = (torch.randn((L, B, H, cap, D), generator=g, device=dev,
                        dtype=bf16) for _ in range(2))
    q = torch.randn((B, H, 1, D), generator=g, device=dev, dtype=bf16)
    mask = masks.decode_mask(cap - 2, cap, 1, device=dev)
    k2_row(rows, f"token decoder's local cache B=8 H={H} S=1 D={D} "
           f"cap={cap}", (k, v), q, mask, 50, path="generation")
    S = cfg.n_expanded_emb
    q = torch.randn((B, H, S, D), generator=g, device=dev, dtype=bf16)
    mask = masks.decode_mask(0, cap, S, device=dev)
    k2_row(rows, f"token decoder's local cache, prefix step B=8 H={H} "
           f"S={S} D={D} cap={cap}", (k, v), q, mask, 50, path="generation")


def phase_bench_kernels(rows, cfg, vcfg):
    """The kernels of ``phase_bench``'s path at its batch (BENCH_BATCH =
    16 rows, where the rows above take 8; K1's and W8A8-mm's plans follow
    M, K2's split of the cache and K3's grid B x H), each row reporting
    the ``bench`` path's launches: K1 at the decode step's linears (M =
    16: the block and token decoders' qkv and mlp_down, the head, the
    baseline's qkv), W8A8 at both prefills' qkv (M = 16 x 512 blocks, 16
    x 2048 tokens), K2 INT8 and K3 (``phase_k2``, ``phase_k3``), K2's warp
    route at the token decoder's local cache (token step and prefix step)
    and the fused K5 at both decode writes (one int offset)."""
    B, path = BENCH_BATCH, "bench"
    g = torch.Generator(device="cuda").manual_seed(17)
    h, m = cfg.block_decoder.hidden_size, cfg.block_decoder.intermediate_size
    vh, L = vcfg.hidden_size, 12
    for label, K, N, layers in (("qkv", h, 3 * h, L), ("mlp_down", m, h, L),
                                ("lm_head", h, cfg.vocab_size, 1),
                                ("baseline qkv", vh, 3 * vh, L)):
        k1_row(rows, g, f"{label} M={B}", B, K, N, layers, path=path)
    Mb = B * PROMPT_TOKENS // cfg.block_length * cfg.n_embedding_tokens
    for label, M, K in (("qkv", Mb, h), ("baseline qkv", B * PROMPT_TOKENS,
                                         vh)):
        w8a8_rows(rows, g, label, M, K, 3 * K, L, path)
    phase_k2(rows, cfg, vcfg, B, path)
    phase_k3(rows, cfg, vcfg, B, path)
    tcfg, dev, bf16 = cfg.token_decoder.neox, "cuda", torch.bfloat16
    H, D, cap = tcfg.num_heads, tcfg.head_dim, cfg.n_expanded_emb + \
        cfg.block_length
    k, v = (torch.randn((tcfg.num_layers, B, H, cap, D), generator=g,
                        device=dev, dtype=bf16) for _ in range(2))
    for S, pos, what in ((1, cap - 2, ""), (cfg.n_expanded_emb, 0,
                                            ", prefix step")):
        q = torch.randn((B, H, S, D), generator=g, device=dev, dtype=bf16)
        k2_row(rows, f"token decoder's local cache{what} B={B} H={H} S={S} "
               f"D={D} cap={cap}", (k, v), q,
               masks.decode_mask(pos, cap, S, device=dev), 50, path=path)
    del k, v
    for L_, cfg_, cap, off in (
            (L, cfg.block_decoder, 640, 517),
            (vcfg.num_layers, vcfg, PROMPT_TOKENS + NEW_TOKENS, 2100)):
        k5_fused_row(rows, g, path, L_, B, cfg_.num_heads, cfg_.head_dim,
                     cap, off)


def launch_floor_ms(iters: int = 200) -> float:
    """Device ms of one launch of an empty kernel (one warp), timed as the
    kernel rows are: the least a launch of any kernel costs on the card."""
    fn = build.load("decode_attention").bt_empty_launch
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def launch():
        build.check(fn(build.raw_stream(0)), "bt_empty_launch")

    return time_ms(launch, iters)


def k3_fma(q, k, v, vecs):
    """K3's CUDA-core kernel through the C entry with the "fma" route code,
    whatever ``route`` would take: a yardstick, not counted as a launch."""
    B, H, Q, D = q.shape
    out = torch.empty_like(q)
    build.check(k3._fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         *(t.data_ptr() for t in vecs), out.data_ptr(), B, H,
                         Q, k.shape[2], D, int(q.dtype == torch.bfloat16),
                         k3.ROUTE_CODES["fma"], build.raw_stream(0)),
                "flash_attention fma")
    return out


def k3_row(rows, label, qkv, mask, iters, plain_iters, path=None,
           route="tc", peak=BF16_FLOPS, tol=TOL, fma=False):
    """K3 against its plain version (within ``tol`` of max|plain|) and SDPA,
    cycling through copies of (q, k, v); asserts ``route`` (the tensor cores
    by default). ``fma``: the CUDA-core kernel too, at the same inputs, its
    error and ms as ``fma_max_abs_err`` and ``fma_ms``."""
    q0, k0, v0 = qkv[0]
    B, H, Q, D = q0.shape
    K = k0.shape[2]
    before = dict(k3.flash_attention.route_launches)
    got = k3.flash_attention(q0, k0, v0, mask)
    if k3.flash_attention.route_launches[route] != before[route] + 1:
        raise AssertionError(f"K3 {label}: not the {route} route")
    want = k3.flash_attention_plain(q0, k0, v0, mask)
    err, pmax = compare(f"K3 {label}", got, want, tol)
    extra = {"attention_route": k3.route(q0.dtype, D, K)}
    it = iter(range(10 ** 9))
    pick = lambda: qkv[next(it) % len(qkv)]   # noqa: E731
    if fma:
        vecs = k3.index_vectors(mask, B, Q, K, q0.device)
        extra["fma_max_abs_err"], _ = compare(
            f"K3 {label} fma", k3_fma(q0, k0, v0, vecs), want, tol)
        extra["fma_ms"] = time_ms(lambda: k3_fma(*pick(), vecs), iters)
    del got, want
    ms = time_ms(lambda: k3.flash_attention(*pick(), mask), iters)
    plain_ms = time_ms(lambda: k3.flash_attention_plain(*pick(), mask),
                       plain_iters)
    allowed = mask.allowed()[:, None]          # [B, 1, Q, K]
    lib_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        *pick(), attn_mask=allowed), iters)
    k_rows, v_rows, ops = attention_need(mask, H, D)
    nbytes = ((2 * B * H * Q + k_rows + v_rows) * D * q0.element_size()
              + (B * Q + K + B * K) * 4)
    record(rows, "K3", label, err, ms, plain_ms, lib_ms, nbytes,
           ops, path=path, peak=peak, extra=extra, plain_max=pmax)


def phase_k3(rows, cfg, vcfg, B=BATCH, path=None):
    """K3 at the fresh prefill's first and last query tiles (B rows, 8 by
    default, H=16, 128 queries against the 512 prompt blocks, D=128,
    block-causal, with left-padded rows whose first queries have no allowed
    key) and at the baseline's prompt (H=16, Q=2048 against the 2176-slot
    cache, D=64, causal: slots from 2048 on carry indices past every query,
    as ``vanilla_prefill`` builds it). ``path``: as ``phase_k2``'s."""
    dev, bf16 = "cuda", torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(3)
    H, D = cfg.block_decoder.num_heads, cfg.block_decoder.head_dim
    Q, K = 128, PROMPT_TOKENS // cfg.block_length
    qkv = [torch.randn((3, B, H, K, D), generator=g, device=dev, dtype=bf16)
           for _ in range(4)]
    valid = torch.ones((B, K), dtype=torch.int32, device=dev)
    for b in range(B):
        valid[b, :13 * b] = 0                  # left pad of 13*b blocks
    full = masks.block_decode_mask(0, K, K, valid)
    for label, t0 in (("first", 0), ("last", K - Q)):
        mask = masks.AttnMask(full.q_idx[t0:t0 + Q], full.kv_idx,
                              full.kv_valid)
        tiles = [(t[0, :, :, t0:t0 + Q].contiguous(), t[1], t[2])
                 for t in qkv]
        k3_row(rows, f"{label} tile B={B} H={H} Q={Q} K={K} D={D}", tiles,
               mask, 50, 20, path=path)
    del qkv, tiles

    H, D = vcfg.num_heads, vcfg.head_dim
    Q, K = PROMPT_TOKENS, PROMPT_TOKENS + NEW_TOKENS
    qkv = [(torch.randn((B, H, Q, D), generator=g, device=dev, dtype=bf16),
            torch.randn((B, H, K, D), generator=g, device=dev, dtype=bf16),
            torch.randn((B, H, K, D), generator=g, device=dev, dtype=bf16))
           for _ in range(2)]
    mask = masks.decode_mask(0, K, Q, torch.ones((B, K), dtype=torch.int32,
                                                 device=dev), device=dev)
    k3_row(rows, f"baseline B={B} H={H} Q={Q} K={K} D={D} causal", qkv,
           mask, 20, 2, path=path or "vanilla")
    del qkv


ENGINE_L, ENGINE_B = 12, pg.ENGINE_SLOTS   # block decoder layers, slots


def random_pools(g, L, P, H, ps, D, packed=False):
    """int8 [L, P, H, ps, D] values (``packed``: INT4, uint8 [..., D/2], each
    byte two nibbles) and f32 [L, P, H, ps] scales, as (k, k_scale, v,
    v_scale)."""
    def values():
        if packed:
            return torch.randint(0, 256, (L, P, H, ps, D // 2), generator=g,
                                 device="cuda", dtype=torch.uint8)
        return torch.randint(-127, 128, (L, P, H, ps, D), generator=g,
                             device="cuda", dtype=torch.int8)

    def f32():
        return 0.01 + 0.02 * torch.rand((L, P, H, ps), generator=g,
                                        device="cuda")

    return [values(), f32(), values(), f32()]


def random_step(g, lead, H, D):
    """One decode step's quantized K/V: (kq, ks, vq, vs)."""
    return (torch.randint(-127, 128, (*lead, H, D), generator=g,
                          device="cuda", dtype=torch.int8),
            torch.rand((*lead, H), generator=g, device="cuda"),
            torch.randint(-127, 128, (*lead, H, D), generator=g,
                          device="cuda", dtype=torch.int8),
            torch.rand((*lead, H), generator=g, device="cuda"))


def exact(name: str, got, want, skip_page0: bool):
    """Pools must be equal bit for bit (outside page 0 if asked): (0.0,
    None), a bit-exact row's error and max|plain|."""
    for a, b in zip(got, want):
        if skip_page0:
            a, b = a[:, 1:], b[:, 1:]
        if not torch.equal(a, b):
            raise AssertionError(f"{name}: kernel and plain pools differ")
    return 0.0, None


def clones(ts):
    return [t.clone() for t in ts]


def phase_k5(rows, cfg):
    """K5 at the contiguous INT8 engine cache's decode write: the cache
    [12, 16, 16, 640, 128] as a pool with one page per slot, 16 rows at
    their frontiers, one finished row at off == cap (dropped)."""
    g = torch.Generator(device="cuda").manual_seed(5)
    L, B = ENGINE_L, ENGINE_B
    H, D, cap = cfg.block_decoder.num_heads, cfg.block_decoder.head_dim, 640
    pools = random_pools(g, L, B, H, cap, D)
    page = torch.arange(B, dtype=torch.int32, device="cuda")
    off = torch.randint(0, cap, (B,), generator=g, device="cuda",
                        dtype=torch.int32)
    off[3] = cap
    step = random_step(g, (B,), H, D)
    want = kp.paged_write_int8_plain(*clones(pools), L // 2, page, off, *step)
    got = kp.paged_write_int8(*clones(pools), L // 2, page, off, *step)
    err, pmax = exact("K5", got, want, skip_page0=False)
    for a, b in zip(got, pools):
        if not torch.equal(a[:, 3], b[:, 3]):
            raise AssertionError("K5: the row at off == cap was written")
    it = iter(range(10 ** 9))
    nxt = lambda: next(it) % L                 # noqa: E731
    ms = time_ms(lambda: kp.paged_write_int8(*pools, nxt(), page, off, *step),
                 200)
    plain_ms = time_ms(lambda: kp.paged_write_int8_plain(
        *pools, nxt(), page, off, *step), 50)
    ok = off < cap
    pg_, of_ = page[ok].long(), off[ok].long()
    new = [t[ok] for t in step]

    def library():
        layer = nxt()
        for pool, val in zip(pools, new):      # [P, ps, H(, D)] views
            pool[layer].transpose(1, 2).index_put_((pg_, of_), val)

    lib_ms = time_ms(library, 200)
    n = int(ok.sum())
    nbytes = 2 * 2 * n * H * (D + 4) + 2 * B * 4     # read + write, page/off
    record(rows, "K5", "B=16 H=16 D=128 pool [12,16,16,640]",
           err, ms, plain_ms, lib_ms, nbytes, 0, plain_max=pmax)
    del pools
    vcfg = config.get_vanilla_config(VANILLA_MODEL)
    for path, L, B, cfg_, cap, off in (
            ("engine int8", L, B, cfg.block_decoder, 640, "rows"),
            ("generation", L, BATCH, cfg.block_decoder, 640, 517),
            ("vanilla", vcfg.num_layers, BATCH, vcfg,
             PROMPT_TOKENS + NEW_TOKENS, 2100)):
        k5_fused_row(rows, g, path, L, B, cfg_.num_heads, cfg_.head_dim, cap,
                     off)


def kv_step_rows(g, B, H, D, dtype=torch.bfloat16):
    """A decode step's K [B, H, D] (RoPE's contiguous output) and V (a
    strided view of the fused qkv output, as ``layer_qkv`` cuts it), in
    ``dtype``."""
    k = torch.randn((B, H, D), generator=g, device="cuda").to(dtype)
    qkv = 2 * torch.randn((B, 1, 3 * H * D), generator=g, device="cuda")
    v = qkv.to(dtype).reshape(B, 1, 3, H, D).permute(
        2, 0, 3, 1, 4)[2][:, :, 0]
    return k, v


# calls of an unfused sequence (21-29 launches) timed in one window: the
# device's ~10 ms spin outlasts their host time, and their ~600 launches
# leave room in the launch queue (a full queue would make the host wait)
UNFUSED_ITERS = 20


def unfused_k5(pools, layer, rows_, off, k, v):
    """The decode write K5 fused replaces, as the parent ran it: quantize_kv
    of K and V (~10 launches each), then K5 at per-row offsets, or four
    slice copies at one int offset."""
    kq, ks = quant.quantize_kv(k)
    vq, vs = quant.quantize_kv(v)
    if isinstance(off, int):
        for buf, val in zip(pools, (kq, ks, vq, vs)):
            buf[layer, :, :, off] = val
    else:
        kp.paged_write_int8(*pools, layer, rows_, off, kq, ks, vq, vs)


def quantize_bound(B, H, D, esize, n_written, extra_bytes=0):
    """(bytes, operations) of quantizing K and V [B, H, D] and writing
    ``n_written`` rows (D int8 bytes and a float32 scale each, K and V):
    the float32 work is ~6 operations an element (abs, max, divide, round,
    clamp twice)."""
    return (2 * B * H * D * esize + 2 * n_written * H * (D + 4)
            + extra_bytes, 6 * 2 * B * H * D)


def k5_fused_row(rows, g, path, L, B, H, D, cap, off, dtype=torch.bfloat16):
    """K5 fused with ``quantize_kv`` at ``path``'s decode write into its
    contiguous INT8 cache [L, B, H, cap, D] (no page table): per-row
    offsets with one finished row at off == cap (``off`` "rows"), or one
    int offset; K and V in ``dtype``; bit for bit against the plain version
    at every layer's first call, timed over rotating layers, beside the
    unfused sequence the parent ran (device ms and host us)."""
    pools = random_pools(g, L, B, H, cap, D)
    if off == "rows":
        off = torch.randint(0, cap, (B,), generator=g, device="cuda",
                            dtype=torch.int32)
        off[3] = cap
    k, v = kv_step_rows(g, B, H, D, dtype)
    want = kp.paged_quantize_write_int8_plain(*clones(pools), L // 2, None,
                                              off, k, v)
    got = kp.paged_quantize_write_int8(*clones(pools), L // 2, None, off, k,
                                       v)
    err, pmax = exact("K5 fused", got, want, skip_page0=False)
    del got, want
    it = iter(range(10 ** 9))
    nxt = lambda: next(it) % L                 # noqa: E731
    ms, host_us = time_ms_host(lambda: kp.paged_quantize_write_int8(
        *pools, nxt(), None, off, k, v), 200)
    plain_ms = time_ms(lambda: kp.paged_quantize_write_int8_plain(
        *pools, nxt(), None, off, k, v), 20)
    rows_ = torch.arange(B, dtype=torch.int32, device="cuda")
    u_ms, u_host = time_ms_host(lambda: unfused_k5(pools, nxt(), rows_, off,
                                                   k, v), UNFUSED_ITERS)
    per_row = torch.is_tensor(off)
    n = int((off < cap).sum()) if per_row else B
    nbytes, ops = quantize_bound(B, H, D, k.element_size(), n,
                                 4 * B if per_row else 0)
    label = (("float32 " if dtype == torch.float32 else "")
             + f"B={B} H={H} D={D} cache [{L},{B},{H},{cap}] "
             + ("per-row off, one at cap" if per_row else f"off {off}"))
    record(rows, "K5 fused", label, err, ms, plain_ms, None, nbytes, ops,
           host_us=host_us, path=path, peak=FP32_FLOPS, plain_max=pmax,
           extra={"unfused_ms": u_ms, "unfused_host_us": u_host})


def engine_pool_case(g, cfg, packed=False):
    """The paged engine's pool [12, 49, 16, 256, 128] (``packed``: the
    paged-int4 engine's, [..., 64] bytes), 16 rows of 3 virtual pages on
    distinct pages; row 0 holds one page, its tail on page 0."""
    L, B = ENGINE_L, ENGINE_B
    H, D = cfg.block_decoder.num_heads, cfg.block_decoder.head_dim
    ps, n_virt = 256, 3
    P = B * n_virt + 1
    pools = random_pools(g, L, P, H, ps, D, packed)
    pt = (1 + torch.randperm(B * n_virt, generator=g, device="cuda")).reshape(
        B, n_virt).to(torch.int32)
    pt[0, 1:] = 0
    return pools, pt, (L, B, H, D, ps, n_virt, P)


def phase_k6(rows, cfg, int4=False):
    """K6 at a paged engine's decode step: 16 rows, ragged lengths (row 0
    within its one page), S=1. INT8 pool: the deferred write, the fresh
    pair on and mask q_idx - 1. Packed INT4 pool (``int4``): no fresh term,
    the step's K/V already written at the frontier, which the mask
    allows."""
    tag = "K6 int4" if int4 else "K6"
    g = torch.Generator(device="cuda").manual_seed(10 if int4 else 6)
    bf16 = torch.bfloat16
    pools, pt, (L, B, H, D, ps, n_virt, P) = engine_pool_case(g, cfg, int4)
    K = ps * n_virt
    frontier = torch.randint(130, K, (B,), generator=g, device="cuda")
    frontier[0] = 200
    valid = (torch.arange(K, device="cuda")[None]
             <= frontier[:, None]).to(torch.int32)
    for b in range(B):
        valid[b, :8 * b] = 0                   # left pad
    q_idx = frontier if int4 else frontier - 1
    mask = masks.AttnMask(q_idx[:, None].to(torch.int32),
                          torch.arange(K, dtype=torch.int32, device="cuda"),
                          valid)
    q = torch.randn((B, H, 1, D), generator=g, device="cuda", dtype=bf16)
    fresh = None if int4 else tuple(
        0.3 * torch.randn((B, H, D), generator=g, device="cuda")
        for _ in range(2))
    got = kp.paged_decode_attention_int8(q, *pools, L // 2, pt, mask,
                                         fresh=fresh)
    want = kp.paged_decode_attention_int8_plain(q, *pools, L // 2, pt, mask,
                                                fresh=fresh)
    err, pmax = compare(tag, got, want)
    it = iter(range(10 ** 9))
    nxt = lambda: next(it) % L                 # noqa: E731
    ms = time_ms(lambda: kp.paged_decode_attention_int8(
        q, *pools, nxt(), pt, mask, fresh=fresh), 100)
    plain_ms = time_ms(lambda: kp.paged_decode_attention_int8_plain(
        q, *pools, nxt(), pt, mask, fresh=fresh), 20)
    ptl = pt.long()
    allowed = mask.allowed()

    def deq(vals, scale, extra):               # pages (+ fresh column), bf16
        x = quant.dequantize_kv(vals[ptl], scale[ptl], bf16).permute(
            0, 2, 1, 3, 4).reshape(B, H, K, D)
        return x if int4 else torch.cat([x, extra[:, :, None].to(bf16)], 2)

    k_deq = [deq(pools[0][i], pools[1][i], fresh and fresh[0])
             for i in range(L)]
    v_deq = [deq(pools[2][i], pools[3][i], fresh and fresh[1])
             for i in range(L)]
    if fresh is not None:
        allowed = torch.cat([allowed, torch.ones(
            (B, 1, 1), dtype=torch.bool, device="cuda")], dim=2)
    allowed = allowed[:, None]

    def library():
        i = nxt()
        return torch.nn.functional.scaled_dot_product_attention(
            q, k_deq[i], v_deq[i], attn_mask=allowed)

    lib_ms = time_ms(library, 100)
    k_rows, v_rows, ops = attention_need(mask, H, D)
    if bool((~mask.allowed().any(-1)).any()):
        raise AssertionError(f"{tag} case: every row should see a pool key")
    row_bytes = (D // 2 if int4 else D) + 4
    nbytes = ((k_rows + v_rows) * row_bytes + 2 * B * H * D * 2
              + (B + K + B * K + B * n_virt) * 4)
    if fresh is not None:                      # kf, vf and their products
        nbytes += 2 * B * H * D * 4
        ops += 4 * B * H * D
    label = ("B=16 H=16 S=1 D=128 packed pool [12,49,16,256] n_virt=3"
             if int4 else
             "B=16 H=16 S=1 D=128 pool [12,49,16,256] n_virt=3 fresh")
    p = k2.plan(B, H, K, build.sm_count(0))
    record(rows, tag, label, err, ms, plain_ms, lib_ms, nbytes, ops,
           extra={"decode_plan": f"splits {p.splits} x {p.slots_per_split} "
                                 "slots"}, plain_max=pmax)
    del k_deq, v_deq


def phase_k7(rows, cfg):
    """K7 after the paged engine's layer loop: kq [12, 16, 16, 128] into the
    pool [12, 49, 16, 256, 128]; row 0 is finished (page 0)."""
    g = torch.Generator(device="cuda").manual_seed(7)
    pools, pt, (L, B, H, D, ps, n_virt, P) = engine_pool_case(g, cfg)
    vp = torch.randint(0, n_virt, (B,), generator=g, device="cuda")
    vp[0] = 0
    page = pt.gather(1, vp[:, None])[:, 0].contiguous()
    page[0] = 0
    off = torch.randint(0, ps, (B,), generator=g, device="cuda",
                        dtype=torch.int32)
    step = random_step(g, (L, B), H, D)
    want = kp.paged_write_layers_int8_plain(*clones(pools), page, off, *step)
    got = kp.paged_write_layers_int8(*clones(pools), page, off, *step)
    err, pmax = exact("K7", got, want, skip_page0=True)
    ms = time_ms(lambda: kp.paged_write_layers_int8(*pools, page, off, *step),
                 200)
    plain_ms = time_ms(lambda: kp.paged_write_layers_int8_plain(
        *pools, page, off, *step), 50)
    lidx = torch.arange(L, device="cuda")[:, None]
    pg_, of_ = page.long()[None], off.long()[None]

    def library():
        for pool, val in zip(pools, step):     # [L, P, ps, H(, D)] views
            pool.transpose(2, 3).index_put_((lidx, pg_, of_), val)

    lib_ms = time_ms(library, 200)
    nbytes = 2 * 2 * L * B * H * (D + 4) + 2 * B * 4
    record(rows, "K7",
           "L=12 B=16 H=16 D=128 pool [12,49,16,256]", err, ms, plain_ms,
           lib_ms, nbytes, 0, plain_max=pmax)
    k7_fused_rows(rows, g, pools, page, off, (L, B, H, D))


def unfused_step(step_q, step_s, i, k, v):
    """A layer's deferred-write feed as the parent ran it: quantize_kv of K
    and V, four step-buffer copies, the dequantized fresh pair (28
    launches)."""
    kq, ks = quant.quantize_kv(k)
    vq, vs = quant.quantize_kv(v)
    step_q[0, i], step_s[0, i] = kq, ks
    step_q[1, i], step_s[1, i] = vq, vs
    return (step_q[0, i].float() * step_s[0, i][..., None],
            step_q[1, i].float() * step_s[1, i][..., None])


def k7_fused_rows(rows, g, pools, page, off, shape):
    """The paged engine's fused deferred write at its step: form (b) at a
    layer < L - 1 (step buffers and fresh pair) and form (c) at the last
    (and K7's write of all 12 layers), each bit for bit against its plain
    version, timed, beside the unfused sequence the parent ran (form (c):
    the feed, then K7)."""
    L, B, H, D = shape
    P = pools[0].shape[1]
    step_q = torch.randint(-127, 128, (2, L, B, H, D), generator=g,
                           device="cuda", dtype=torch.int8)
    step_s = torch.rand((2, L, B, H), generator=g, device="cuda")
    k, v = kv_step_rows(g, B, H, D)
    step, step_plain = kp.paged_quantize_step_int8, \
        kp.paged_quantize_step_int8_plain
    last, last_plain = kp.paged_quantize_write_layers_int8, \
        kp.paged_quantize_write_layers_int8_plain
    forms = {   # (fused, plain) on (step_q, step_s, pools), and the unfused
        "step": (lambda sq, ss, _: step(sq, ss, L // 2, k, v),
                 lambda sq, ss, _: step_plain(sq, ss, L // 2, k, v),
                 lambda: unfused_step(step_q, step_s, L // 2, k, v)),
        "fused": (lambda sq, ss, ps_: last(*ps_, page, off, sq, ss, k, v),
                  lambda sq, ss, ps_: last_plain(*ps_, page, off, sq, ss, k,
                                                 v),
                  lambda: (unfused_step(step_q, step_s, L - 1, k, v),
                           kp.paged_write_layers_int8(
                               *pools, page, off, step_q[0], step_s[0],
                               step_q[1], step_s[1]))),
    }
    for form, (fused, plain, unfused) in forms.items():
        tag = f"K7 {form}"
        got, want = [], []
        for fn, out in ((fused, got), (plain, want)):
            sq, ss, ps_ = step_q.clone(), step_s.clone(), clones(pools)
            out.extend([*fn(sq, ss, ps_), sq, ss, *ps_])
        # the fresh pair and step buffers, then the pools outside page 0
        err, pmax = exact(tag, got[:4], want[:4], skip_page0=False)
        exact(tag, got[4:], want[4:], skip_page0=True)
        del got, want
        ms, host_us = time_ms_host(lambda: fused(step_q, step_s, pools), 200)
        plain_ms = time_ms(lambda: plain(step_q, step_s, pools), 20)
        u_ms, u_host = time_ms_host(unfused, UNFUSED_ITERS)
        fresh_bytes = 2 * B * H * D * 4
        if form == "step":
            nbytes, ops = quantize_bound(B, H, D, 2, B, fresh_bytes)
            label = f"layer {L // 2} of L={L} B={B} H={H} D={D}"
        else:
            n = int(((page >= 0) & (page < P) & (off >= 0)
                     & (off < pools[0].shape[3])).sum())
            copy = 2 * (L - 1) * B * H * (D + 4) + 2 * L * n * H * (D + 4)
            nbytes, ops = quantize_bound(B, H, D, 2, B,
                                         fresh_bytes + copy + 2 * B * 4)
            label = (f"layer {L - 1} and K7 of L={L} B={B} H={H} D={D} pool "
                     f"[{L},{P},{H},{pools[0].shape[3]}]")
        record(rows, tag, label, err, ms, plain_ms, None, nbytes, ops,
               host_us=host_us, peak=FP32_FLOPS, plain_max=pmax,
               extra={"unfused_ms": u_ms, "unfused_host_us": u_host})


def phase_k8(rows, cfg, int4=False):
    """K8 at a paged engine's admission of 16 rows: rows
    [12, 16, 16, 768, 128] into the pool [12, 49, 16, 256, 128], 3 pages a
    row (row 0's tail on page 0); ``int4``: packed rows and pool, [..., 64]
    bytes."""
    tag = "K8 int4" if int4 else "K8"
    g = torch.Generator(device="cuda").manual_seed(11 if int4 else 8)
    pools, pt, (L, B, H, D, ps, n_virt, P) = engine_pool_case(g, cfg, int4)
    src = random_pools(g, L, B, H, n_virt * ps, D, int4)
    want = kp.paged_page_copy_int8_plain(*clones(pools), pt, *src)
    got = kp.paged_page_copy_int8(*clones(pools), pt, *src)
    err, pmax = exact(tag, got, want, skip_page0=True)
    ms = time_ms(lambda: kp.paged_page_copy_int8(*pools, pt, *src), 20)
    plain_ms = time_ms(lambda: kp.paged_page_copy_int8_plain(
        *pools, pt, *src), 5)
    ptl = pt.long()
    pages = [kp._pages(t, n_virt) for t in src]   # strided views

    def library():
        for pool, val in zip(pools, pages):
            pool[:, ptl] = val

    lib_ms = time_ms(library, 5)
    row_bytes = (D // 2 if int4 else D) + 4
    nbytes = 2 * 2 * L * B * n_virt * H * ps * row_bytes + B * n_virt * 4
    record(rows, tag, "L=12 G=16 nv=3 ps=256 H=16 D=128"
           + (" packed" if int4 else ""), err, ms, plain_ms, lib_ms, nbytes, 0,
           plain_max=pmax)
    del src, pages


def phase_family_kernels(rows):
    """The kernels at the ablation families' new shapes (hidden 768, heads
    of 64): W8A8-q and W8A8-mm (``w8a8_rows``) at block_uniform_b4_85's
    prefill qkv over its 6 layers (M = 8 x 293 blocks = 2344, a partial
    last tile of tokens; K = 768, N = 2304; bit for bit), K3 at its last
    query tile (Q = 37 of 293 blocks, K = 293, B=8, H=12, D=64,
    block-causal, rows left-padded by 4*b blocks as the prompts are), K2
    bf16 (warp route) at its token decoder's local cache at the last token
    step (capacity n_exp + 7 = 9), K2 INT8 at block_megabyte_b4_85's
    decode step (B=8, H=12, S=1, D=64, its
    11 layers of capacity 640 filled to 530, some rows finished, one with
    no allowed key) and K1 at that model's token decoder qkv (M = B x 4 =
    32, K = 512, N = 1536, over its 4 layers)."""
    dev, bf16 = "cuda", torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(14)
    name = "block_uniform_b4_85"
    cfg = family_config(name)
    bcfg = cfg.block_decoder
    h, H, D = bcfg.hidden_size, bcfg.num_heads, bcfg.head_dim
    K = -(-PROMPT_TOKENS // cfg.block_length)           # 293 prompt blocks
    w8a8_rows(rows, g, "uniform qkv", BATCH * K, h, 3 * h, bcfg.num_layers,
              family_path(name))
    B, Q = BATCH, K % 128
    qkv = [torch.randn((3, B, H, K, D), generator=g, device=dev, dtype=bf16)
           for _ in range(4)]
    valid = torch.ones((B, K), dtype=torch.int32, device=dev)
    for b in range(B):
        valid[b, :4 * b] = 0
    full = masks.block_decode_mask(0, K, K, valid)
    mask = masks.AttnMask(full.q_idx[K - Q:], full.kv_idx, full.kv_valid)
    tiles = [(t[0, :, :, K - Q:].contiguous(), t[1], t[2]) for t in qkv]
    k3_row(rows, f"uniform last tile B=8 H={H} Q={Q} K={K} D={D}", tiles,
           mask, 50, 20, path=family_path(name))
    del qkv, tiles
    tcfg = cfg.token_decoder.neox
    cap = cfg.n_expanded_emb + cfg.block_length
    k, v = (torch.randn((tcfg.num_layers, B, H, cap, D), generator=g,
                        device=dev, dtype=bf16) for _ in range(2))
    q = torch.randn((B, H, 1, D), generator=g, device=dev, dtype=bf16)
    k2_row(rows, f"uniform local cache B=8 H={H} S=1 D={D} cap={cap}",
           (k, v), q, masks.decode_mask(cap - 2, cap, 1, device=dev), 50,
           path=family_path(name))

    name = "block_megabyte_b4_85"
    cfg = family_config(name)
    cap, filled = 640, 530
    cache = int8_layers(g, cfg.block_decoder.num_layers, B, H, cap, D)
    q = torch.randn((B, H, 1, D), generator=g, device=dev, dtype=bf16)
    valid = torch.zeros((B, cap), dtype=torch.int32, device=dev)
    for b in range(B):
        valid[b, 16 * b:filled] = 1
    valid[B - 2:, filled - 4:filled] = 0
    valid[0] = 0
    mask = masks.block_decode_mask(filled - 1, cap, 1, valid)
    k2_row(rows, f"megabyte B=8 H={H} S=1 D={D} cap={cap}", cache, q, mask,
           100, path=family_path(name))
    del cache
    t = cfg.token_decoder.neox
    k1_row(rows, g, f"megabyte token decoder qkv M={B * cfg.block_length}",
           B * cfg.block_length, t.hidden_size, 3 * t.hidden_size,
           t.num_layers, path=family_path(name))


# small versions of the families for the card-against-CPU check: (block
# length, embedder fields, token decoder fields, block decoder class); all
# at hidden 128, 2 layers, vocab 512
SMALL_FAMILIES = {
    "megabyte": (4, dict(hidden_size=32),
                 dict(decoding_strategy="summation", expansion_ratio=None),
                 "gpt-neo-x"),
    "cls_cross_attn": (4, dict(cls="roberta_cls", hidden_size=64,
                               n_cls_tokens=2),
                       dict(decoding_strategy="cross_attention",
                            expansion_ratio=None, cls="t5"), "gpt-neo-x"),
    "uniform": (7, dict(hidden_size=32, projection_method="projection_layer"),
                dict(expansion_ratio=2), "gpt-neo-x"),
    "roberta_prefix": (4, dict(cls="roberta", hidden_size=32),
                       dict(expansion_ratio=2), "gpt-neo-x"),
    "t5_embedder": (4, dict(cls="t5", hidden_size=32),
                    dict(expansion_ratio=2), "gpt-neo-x"),
    "gpt_neo": (4, dict(hidden_size=32),
                dict(expansion_ratio=2, cls="gpt-neo"), "gpt-neo"),
}


def small_family_config(name: str) -> config.BlockTransformerConfig:
    block_length, emb_fields, td_fields, bd_cls = SMALL_FAMILIES[name]
    neox_cfg = NeoXConfig.from_hidden_layers(128, 2, vocab_size=512,
                                             max_position_embeddings=64)
    return config.BlockTransformerConfig(
        block_length=block_length,
        embedder=config.EmbedderConfig(vocab_size=512,
                                       projection_hidden_size=128,
                                       encoder_layers=2, **emb_fields),
        block_decoder=neox_cfg,
        token_decoder=config.TokenDecoderConfig(neox=neox_cfg, **td_fields),
        block_decoder_cls=bd_cls, block_decoder_window=4,
        name=f"small {name}")


def quiet_eos(params, cfg):
    """Random weights for generation: a T5 token decoder's tied embedding
    row of token 0, which is its BOS, pad and EOS at once, scaled by 0.02.
    At random init (rows N(0, 1)) the decoder fed [BOS, pad, ...] predicts
    its own input, so every row would end at EOS in the first block (in the
    JAX package as well); the other families are left as they are."""
    if cfg.token_decoder.cls == "t5":
        params["token_decoder"]["t5"]["embed"]["weight"][
            cfg.eos_token_id] *= 0.02
    return params


def phase_small_families():
    """Every ablation family on the card (kernels) against the same port on
    the CPU (plain versions), small configurations, float32, INT8 weights
    (``quiet_eos``):
    forward logits within TOL of their largest magnitude, and greedy tokens
    of ``generate_blocks`` equal with the INT8 global cache (GPT-Neo: the
    unquantized cache, float32 here, through the streaming prefill, the
    only cache and prefill it takes)."""
    rng = np.random.default_rng(8)
    for name in SMALL_FAMILIES:
        cfg = small_family_config(name)
        params = quant.quantize_block_transformer(quiet_eos(
            bt.init_block_transformer_params(8, cfg, device="cpu"), cfg),
            bits=8)
        card = to_card(params)
        B, N, L = 2, 12, cfg.block_length
        ids = rng.integers(1, cfg.vocab_size, (B, N, L)).astype(np.int32)
        att = np.ones_like(ids)
        ids[1, :2], att[1, :2] = 0, 0
        ids[0, 3, 2:], att[0, 3, 2:] = 0, 0       # padded tokens in a block
        bam = att.any(-1).astype(np.int32)
        args = [torch.from_numpy(a) for a in (ids, att, bam)]
        want = bt.block_transformer_forward(params, cfg, *args).logits
        got = bt.block_transformer_forward(
            card, cfg, *[a.to(CARD) for a in args]).logits
        err = (got.cpu() - want).abs().max().item()
        scale = want.abs().max().item()
        if not bool(torch.isfinite(got).all()) or err > TOL * scale:
            raise AssertionError(f"small family {name}: card vs CPU logits "
                                 f"differ by {err} (max |logit| {scale})")
        kv = "bf16" if cfg.block_decoder_cls == "gpt-neo" else "int8"
        res = [gen.generate_blocks(p, cfg, ids, att, bam, max_blocks=N + 4,
                                   kv_cache=kv, device=d)
               for p, d in ((params, "cpu"), (card, CARD))]
        if res[0].n_blocks != res[1].n_blocks or not torch.equal(
                res[0].tokens, res[1].tokens.cpu()):
            raise AssertionError(f"small family {name} kv {kv}: card and "
                                 "CPU tokens differ")
        log(f"small family {name}: logits max err {err:.3e} (max |logit| "
            f"{scale:.3e}); greedy tokens equal on the card and the CPU, "
            f"int8 weights + {kv} KV ({res[1].n_blocks} blocks)")


def family_prompts(cfg):
    """The families' prompts: PROMPT_TOKENS tokens rounded up to whole
    blocks (293 blocks of 7 tokens at block length 7), random, row b
    left-padded by 4*b blocks."""
    L = cfg.block_length
    return pg.ragged_prompts(cfg, BATCH, -(-PROMPT_TOKENS // L) * L, seed=0)


def inner_loop_seconds(run):
    """(run s, inner-loop s) of one more ``run``, the device synchronized
    around each ``decode_block_tokens`` call to time the token decoder's
    share (the synchronizations slow the run a little)."""
    inner = 0.0
    decode = gen.decode_block_tokens

    def timed(*args, **kw):
        nonlocal inner
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = decode(*args, **kw)
        torch.cuda.synchronize()
        inner += time.perf_counter() - t0
        return out

    gen.decode_block_tokens = timed
    try:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        gen.decode_block_tokens = decode
    return total, inner


def phase_families(smi: str) -> dict:
    """The four shipped ablation configs at full width (FAMILY_NAMES),
    random bf16 weights from a seed (``quiet_eos``) quantized to INT8, the
    INT8 global cache, greedy ``generate_blocks``, B=8, PROMPT_TOKENS prompt
    tokens (rounded up to whole blocks) and NEW_TOKENS new ones: one
    warm-up run, then a timed run between launch-count resets, asserting
    that it reached its last block and that every kernel of the path ran
    on its main route (K2's bf16 form by the warp route on the prefix
    decoders' local cache, and not on the re-run decoders), W8A8 on the
    block decoder's prefill linears alone; then the prefill alone, and one
    more run with the inner loop timed. Returns {path: launches}."""
    out = {}
    for name in FAMILY_NAMES:
        cfg = family_config(name)
        prefix = cfg.token_decoder.decoding_strategy == "prefix"
        path = add_family_path(name, prefix)
        t0 = time.perf_counter()
        params = quant.quantize_block_transformer(quiet_eos(
            bt.init_block_transformer_params(0, cfg, dtype=torch.bfloat16,
                                             device=CARD), cfg), bits=8)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        ids, att, bam = family_prompts(cfg)
        L, N, n = cfg.block_length, ids.shape[1], cfg.n_embedding_tokens
        max_blocks = N + -(-NEW_TOKENS // L)

        def run():
            return gen.generate_blocks(params, cfg, ids, att, bam,
                                       max_blocks=max_blocks, kv_cache="int8",
                                       device=CARD)

        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        reset_launches()
        with W8A8Decisions() as decisions:
            t0 = time.perf_counter()
            res = run()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        out[path] = read_launches(path)
        decisions.check(path, out[path],
                        (4 * cfg.block_decoder.num_layers, BATCH * N * n))
        toks = res.tokens
        if tuple(toks.shape) != (BATCH, max_blocks, L):
            raise AssertionError(f"{name}: tokens shape {tuple(toks.shape)}")
        if int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size:
            raise AssertionError(f"{name}: tokens out of [0, vocab)")
        if not torch.equal(toks[:, :N].cpu(), torch.from_numpy(ids)):
            raise AssertionError(f"{name}: prompt blocks were not kept")
        generated = BATCH * (res.n_blocks - N) * L
        if res.n_blocks != max_blocks:
            raise AssertionError(f"{name}: {res.n_blocks - N} blocks "
                                 f"generated, not {max_blocks - N}")

        capacity = -(-max_blocks * n // 128) * 128
        dev_args = [torch.as_tensor(a, device=CARD) for a in (ids, att, bam)]
        with linear_ops.kv_mode("int8"):
            t0 = time.perf_counter()
            gen.prefill_blocks(params, cfg, *dev_args, capacity=capacity,
                               kv_cache="int8")
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0
        total_s, inner_s = inner_loop_seconds(run)
        strategy = cfg.token_decoder.decoding_strategy
        loop = "cached" if prefix else "re-run"
        log(f"{name} ({cfg.embedder.cls} embedder, {strategy} "
            f"{cfg.token_decoder.cls} token decoder, L={L}) generate_blocks "
            f"B={BATCH} p{N * L}/d{NEW_TOKENS} int8 weights + int8 KV: init "
            f"+ quantization {init_s:.2f} s; {res.n_blocks - N} blocks "
            f"generated; warm-up run {warm_s:.2f} s; timed run {secs:.3f} s "
            f"= {generated / secs:.1f} tok/s (prefill included); prefill "
            f"alone {prefill_s:.3f} s; a run with the {loop} inner loop "
            f"timed: {total_s:.3f} s, the inner loop {inner_s:.3f} s "
            f"({inner_s / total_s:.1%}); peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        log(json.dumps({"family": name, "inner_loop": loop, "run_s": secs,
                        "generated_tok_s": generated / secs,
                        "prefill_s": prefill_s, "timed_inner_run_s": total_s,
                        "inner_loop_s": inner_s, "card": smi}))
        del params, res
    return out


def small_config(bits: int = 8):
    cfg = config.make_block_config("smoke", 128, 2, vocab_size=512)
    params = bt.init_block_transformer_params(0, cfg, device="cpu")
    return cfg, quant.quantize_block_transformer(params, bits=bits)


def to_card(tree):
    if isinstance(tree, dict):
        return {k: to_card(v) for k, v in tree.items()}
    return tree.cuda()


def routes_since(fn, before: dict) -> dict:
    """A wrapper's launches by route since ``before`` (its route_launches)."""
    return {r: n - before[r] for r, n in fn.route_launches.items()}


def check_k3_routes(what: str, before: dict, head_dim: int) -> dict:
    """K3's launches by route since ``before`` on a float32 run at
    ``head_dim``: logged, and all by the route ``route`` gives that head
    dim."""
    got = routes_since(k3.flash_attention, before)
    want = k3.route(torch.float32, head_dim, 1)
    log(f"{what}: K3 by route {json.dumps(got)} (float32, head dim "
        f"{head_dim}: {want})")
    if got[want] <= 0 or sum(got.values()) != got[want]:
        raise AssertionError(f"{what}: K3 not by its {want} route alone: "
                             f"{got}")
    return got


def phase_small_engine():
    """The serving engine on the card (kernels) against the same engine on
    the CPU (plain versions): small configuration, float32, INT8 weights,
    3 slots, 5 requests of uneven prompts and budgets; contiguous INT8 and
    INT4 caches and paged INT8 and INT4 pools (page size 4). K3's route is
    logged and checked."""
    cfg, qparams = small_config()
    traffic = ((1, 37, 9), (1, 12, 30), (1, 64, 5), (1, 5, 17), (1, 26, 12))
    requests = pg.engine_requests(cfg, traffic, seed=3)
    before = dict(k3.flash_attention.route_launches)
    for kind in pg.ENGINE_KINDS:
        out = []
        for params, dev in ((qparams, "cpu"), (to_card(qparams), "cuda")):
            eng = pg.make_engine(params, cfg, kind, n_slots=3, max_blocks=40,
                                 bucket_blocks=4, page_size=4, device=dev)
            res = pg.serve(eng, requests)
            out.append([r.generated for r in res["requests"]])
        if out[0] != out[1] or not all(out[0]):
            raise AssertionError(f"small engine {kind}: card and CPU tokens "
                                 f"differ:\n{out[0]}\n{out[1]}")
        log(f"small engine {kind}: greedy tokens equal on the card and the "
            f"CPU ({sum(map(len, out[0]))} tokens, 5 requests, 3 slots)")
    check_k3_routes("small engine", before, cfg.block_decoder.head_dim)


def phase_small_reference():
    """The port on the card (kernels) against the port on the CPU (plain
    versions), small configuration, float32."""
    cfg, qparams = small_config()
    to_dev = to_card
    rng = np.random.default_rng(0)
    B, N, L = 2, 12, cfg.block_length
    ids = rng.integers(1, cfg.vocab_size, (B, N, L)).astype(np.int32)
    att = np.ones_like(ids)
    ids[1, :2], att[1, :2] = 0, 0              # a left-padded row
    bam = att.any(-1).astype(np.int32)
    args = [torch.from_numpy(a) for a in (ids, att, bam)]
    want = bt.block_transformer_forward(qparams, cfg, *args).logits
    got = bt.block_transformer_forward(to_dev(qparams), cfg,
                                       *[a.cuda() for a in args]).logits
    err = (got.cpu() - want).abs().max().item()
    if err > 1e-3:
        raise AssertionError(f"small forward: card vs CPU logits differ by {err}")
    log(f"small reference: logits max err {err:.3e}")
    for kv in ("int8", "int4", "bf16"):
        run = lambda p, d: gen.generate_blocks(  # noqa: E731
            p, cfg, ids, att, bam, max_blocks=N + 4, kv_cache=kv, device=d)
        t_cpu, t_gpu = run(qparams, "cpu"), run(to_dev(qparams), "cuda")
        if t_cpu.n_blocks != t_gpu.n_blocks or not torch.equal(
                t_cpu.tokens, t_gpu.tokens.cpu()):
            raise AssertionError(f"small generation kv {kv}: card and CPU "
                                 "tokens differ")
        log(f"small generation kv {kv}: greedy tokens equal on the card and "
            f"the CPU ({t_gpu.n_blocks} blocks)")


def phase_small_quantized():
    """INT4 and mixed48 weights (group size 32) and the vanilla baseline
    (INT8 and INT4 weights, INT8 KV) on the card against the CPU: small
    configurations, float32, greedy tokens equal."""
    cfg = config.make_block_config("smoke", 128, 2, vocab_size=512)
    params = bt.init_block_transformer_params(0, cfg, device="cpu")
    rng = np.random.default_rng(1)
    B, N, L = 2, 12, cfg.block_length
    ids = rng.integers(1, cfg.vocab_size, (B, N, L)).astype(np.int32)
    att = np.ones_like(ids)
    ids[1, :2], att[1, :2] = 0, 0
    bam = att.any(-1).astype(np.int32)
    for kind in ("int4", "mixed48"):
        q = quant.quantize_block_transformer(
            params, **dict(pg.QUANTIZE[kind], group_size=32))
        res = [gen.generate_blocks(p, cfg, ids, att, bam, max_blocks=N + 4,
                                   kv_cache="int8", device=d)
               for p, d in ((q, "cpu"), (to_card(q), "cuda"))]
        if res[0].n_blocks != res[1].n_blocks or not torch.equal(
                res[0].tokens, res[1].tokens.cpu()):
            raise AssertionError(f"small generation {kind}: card and CPU "
                                 "tokens differ")
        log(f"small generation {kind}: greedy tokens equal on the card and "
            f"the CPU ({res[1].n_blocks} blocks)")
    vcfg = NeoXConfig.from_hidden_layers(128, 2, vocab_size=512, num_heads=4)
    vparams = vanilla.init_vanilla_params(0, vcfg, device="cpu")
    vids = torch.from_numpy(rng.integers(1, 512, (2, 12)).astype(np.int32))
    for bits in (8, 4):
        q = quant.quantize_model_params(vparams, bits, group_size=32)
        toks = [pg.vanilla_generate(p, vcfg, i, 6)
                for p, i in ((q, vids), (to_card(q), vids.cuda()))]
        if not torch.equal(toks[0], toks[1].cpu()):
            raise AssertionError(f"small vanilla int{bits}: card and CPU "
                                 f"tokens differ")
        log(f"small vanilla int{bits} weights + int8 KV: greedy tokens equal "
            f"on the card and the CPU ({toks[1].shape[1]} per row)")


class W8A8Decisions:
    """Records every W8A8 decision taken inside, as (M, taken): the card's
    INT8 linears each ask ``ops.linear._use_w8a8`` once."""

    def __enter__(self):
        self.seen, self._use = [], linear_ops._use_w8a8

        def use(m):
            taken = self._use(m)
            self.seen.append((m, taken))
            return taken

        linear_ops._use_w8a8 = use
        return self

    def __exit__(self, *exc):
        linear_ops._use_w8a8 = self._use

    def check(self, path: str, launches: dict, taken_at=None) -> None:
        """W8A8-q and W8A8-mm launched once for each decision taken and K1
        once for each one left to it; ``taken_at``: (count, M) the run must
        have taken (all at that M)."""
        taken = [m for m, t in self.seen if t]
        left = [m for m, t in self.seen if not t]
        log(f"W8A8 in the timed {path} run: {len(taken)} linears (M "
            f"{sorted(set(taken))}), {len(left)} to K1 (M "
            f"{sorted(set(left))})")
        if not launches["W8A8-q"] == launches["W8A8-mm"] == len(taken):
            raise AssertionError(f"{path}: W8A8 launches {launches['W8A8-q']}"
                                 f" / {launches['W8A8-mm']} for {len(taken)} "
                                 "linears that took it")
        if launches["K1"] != len(left):
            raise AssertionError(f"{path}: K1 launches {launches['K1']} for "
                                 f"{len(left)} linears left to it")
        if taken_at is not None and (len(taken), set(taken)) != (
                taken_at[0], {taken_at[1]} if taken_at[0] else set()):
            raise AssertionError(f"{path}: W8A8 took {len(taken)} linears at "
                                 f"M {sorted(set(taken))}, not {taken_at[0]}"
                                 f" at M {taken_at[1]}")


def phase_small_w8a8():
    """W8A8 and the streaming prefill on the card (kernels) against the CPU
    (plain versions), float32, greedy tokens equal: ``block_main_b4_5``
    (random weights, INT8, INT8 KV) with W8A8 forced at every M, the CPU
    run taking W8A8's plain versions through the port's card gate, opened
    for it; then ``generate_blocks(fresh_prefill=False)`` on the bf16, INT8
    and INT4 caches at the small configuration, 12 prompt blocks in chunks
    of 5 (padded to 15 of 16 slots)."""
    cfg = config.get_config("block_main_b4_5")
    params = quant.quantize_block_transformer(
        bt.init_block_transformer_params(5, cfg, device="cpu"), bits=8)
    rng = np.random.default_rng(5)
    B, N, L = 2, 12, cfg.block_length
    ids = rng.integers(1, cfg.vocab_size, (B, N, L)).astype(np.int32)
    att = np.ones_like(ids)
    ids[1, :2], att[1, :2] = 0, 0
    bam = att.any(-1).astype(np.int32)
    run = lambda p, d: gen.generate_blocks(  # noqa: E731
        p, cfg, ids, att, bam, max_blocks=N + 4, kv_cache="int8", device=d)
    with linear_ops.w8a8_min_m(1):
        before = w8a8.w8a8_matmul_stacked.launches
        card = run(to_card(params), "cuda")
        launched = w8a8.w8a8_matmul_stacked.launches - before
        gate = linear_ops._on_card
        linear_ops._on_card = lambda x: True
        try:
            cpu = run(params, "cpu")
        finally:
            linear_ops._on_card = gate
    if launched <= 0 or card.n_blocks != cpu.n_blocks or not torch.equal(
            card.tokens.cpu(), cpu.tokens):
        raise AssertionError(f"small block_main_b4_5 W8A8: card and CPU "
                             f"tokens differ ({launched} W8A8-mm launches)")
    log(f"small block_main_b4_5 INT8 with W8A8 at every M: greedy tokens "
        f"equal on the card and the CPU ({card.n_blocks} blocks, "
        f"{launched} W8A8-mm launches)")

    cfg, qparams = small_config()
    ids = rng.integers(1, cfg.vocab_size, (B, N, L)).astype(np.int32)
    for kv in ("bf16", "int8", "int4"):
        run = lambda p, d: gen.generate_blocks(  # noqa: E731
            p, cfg, ids, att, bam, max_blocks=N + 4, kv_cache=kv,
            prefill_chunk_blocks=5, fresh_prefill=False, device=d)
        t_cpu, t_gpu = run(qparams, "cpu"), run(to_card(qparams), "cuda")
        if t_cpu.n_blocks != t_gpu.n_blocks or not torch.equal(
                t_cpu.tokens, t_gpu.tokens.cpu()):
            raise AssertionError(f"small streaming prefill kv {kv}: card "
                                 "and CPU tokens differ")
        log(f"small generation kv {kv}, streaming prefill (chunks of 5 "
            f"blocks): greedy tokens equal on the card and the CPU "
            f"({t_gpu.n_blocks} blocks)")


def reset_launches():
    for fn, *_ in KERNELS:
        fn.launches = 0
        if hasattr(fn, "form_launches"):
            fn.form_launches = dict.fromkeys(fn.form_launches, 0)
    for fn, _ in ROUTED.values():
        fn.route_launches = dict.fromkeys(fn.route_launches, 0)
    k2.decode_attention_stacked.route_launches = dict.fromkeys(
        k2.decode_attention_stacked.route_launches, 0)


def read_launches(path: str) -> dict:
    """{tag: launches} since the last reset (a K6/K8 tag: its pool width's
    launches; "K2 bf16 warp" and "K2 bf16 split": K2 bf16's by route);
    fails if a kernel of ``path`` did not run, or one it must not run
    did."""
    launches = {tag: fn.launches if form is None else fn.form_launches[form]
                for fn, tag, *_, form in KERNELS}
    routes = {tag: dict(fn.route_launches)
              for tag, (fn, _) in ROUTED.items()}
    log(f"launches in the timed {path} run: {json.dumps(launches)}; K1/K3/"
        f"K4/W8A8-mm by route: {json.dumps(routes)}")
    for tag in PATH_KERNELS[path]:
        if launches[tag] <= 0:
            raise AssertionError(f"{tag} was not launched on the {path} path")
    for tag in PATH_ABSENT.get(path, ()) + OFF_PATH:
        if launches[tag]:
            raise AssertionError(f"{tag} was launched on the {path} path")
    for tag, by_route in routes.items():     # full width: one route only
        want = PATH_ROUTES.get(path, {}).get(tag, ROUTED[tag][1])
        if by_route[want] != launches[tag] or sum(by_route.values()) != \
                launches[tag]:
            raise AssertionError(f"{tag} took another route than {want} on "
                                 f"the {path} path: {by_route}")
    # K2 bf16 serves the token decoder's local cache by the warp route, and
    # only the bf16 global cache by the split route
    k2_routes = dict(k2.decode_attention_stacked.route_launches)
    log(f"K2 bf16 by route in the timed {path} run: {json.dumps(k2_routes)}")
    if "K2 bf16" in PATH_KERNELS[path] and (k2_routes["warp"] > 0) == (
            path in K2_NO_LOCAL_CACHE):
        raise AssertionError(f"K2 bf16's warp route (the token decoder's "
                             f"local cache) on the {path} path: {k2_routes}")
    if (k2_routes["split"] > 0) != (path in K2_SPLIT_PATHS):
        raise AssertionError(f"K2 bf16's split route on the {path} path: "
                             f"{k2_routes}")
    launches.update({f"K2 bf16 {r}": n for r, n in k2_routes.items()})
    return launches


# the paths whose device launches a run are counted in a trace, one more
# run each under torch.profiler (``profile_generate.device_breakdown``):
# every kernel, copy and fill, and the device's busy seconds
TRACED_PATHS = ("generation", "vanilla", "engine int8", "engine paged")
device_launches = {}
# the traced kernels held against the launch counts of their wrappers
TRACED_KERNELS = {
    "paged_quantize_write_kernel": (kp.paged_quantize_write_int8,
                                    kp.paged_quantize_step_int8,
                                    kp.paged_quantize_write_layers_int8),
    "paged_write_kernel": (kp.paged_write_int8, kp.paged_write_layers_int8),
}


def trace_launches(path: str, run) -> None:
    """Trace one more run of ``path``; fails unless the trace holds as
    many launches of each of TRACED_KERNELS as its wrappers counted."""
    if path not in TRACED_PATHS:
        return
    reset_launches()
    per, busy_us = pg.device_breakdown(run)
    for kernel, fns in TRACED_KERNELS.items():
        traced = sum(n for name, (_, n) in per.items()
                     if f"::{kernel}<" in name or f"::{kernel}(" in name)
        counted = sum(fn.launches for fn in fns)
        log(f"{kernel} in the traced {path} run: {traced} launches traced, "
            f"{counted} counted by its wrappers")
        if traced != counted:
            raise AssertionError(f"{path}: the trace holds {traced} launches "
                                 f"of {kernel}, its wrappers counted "
                                 f"{counted}")
    device_launches[path] = {"launches": sum(n for _, n in per.values()),
                             "busy_s": busy_us / 1e6}


def generation_path(quantize: str, kv: str, fresh: bool = True) -> str:
    if not fresh:
        return "generation streaming"
    if kv != "int8":
        return f"generation kv {kv}"
    return "generation" if quantize == "int8" else f"generation {quantize}"


def phase_generation(cfg, params, quantize: str, kv: str = "int8",
                     fresh: bool = True, weights: str = None):
    """Full-width generation with ``quantize`` weights and the ``kv`` global
    cache, the fresh prefill or (``fresh=False``) the streaming one in 4
    chunks of 128 blocks; returns the launches of the timed run and its
    tokens per second. Asserts the W8A8 decisions: an INT8 block decoder's
    fresh prefill takes W8A8 for its 48 linears (12 layers x 4) at M =
    4096, the streaming chunks (M = 1024 under the INT8 cache) take none,
    and every other INT8 linear takes K1. ``weights`` names where the
    weights came from in the log (default: random, ``quantize`` RTN)."""
    path = generation_path(quantize, kv, fresh)
    torch.cuda.reset_peak_memory_stats()
    ids, att, bam = pg.ragged_prompts(cfg, BATCH, PROMPT_TOKENS, seed=0)
    L, N = cfg.block_length, ids.shape[1]
    max_blocks = N + NEW_TOKENS // L

    def run():
        return gen.generate_blocks(params, cfg, ids, att, bam,
                                   max_blocks=max_blocks, kv_cache=kv,
                                   fresh_prefill=fresh, device="cuda")

    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    reset_launches()
    with W8A8Decisions() as decisions:
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    launches = read_launches(path)
    trace_launches(path, run)
    layers = cfg.block_decoder.num_layers
    decisions.check(path, launches, None if quantize == "int4" else (
        4 * layers, BATCH * N * cfg.n_embedding_tokens) if fresh else (0, 0))

    toks = res.tokens
    if tuple(toks.shape) != (BATCH, max_blocks, L):
        raise AssertionError(f"tokens shape {tuple(toks.shape)}")
    if int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size:
        raise AssertionError("tokens out of [0, vocab)")
    if not torch.equal(toks[:, :N].cpu(), torch.from_numpy(ids)):
        raise AssertionError("prompt blocks were not kept")
    generated = BATCH * (res.n_blocks - N) * L
    log(f"{MODEL} generate_blocks B={BATCH} p{PROMPT_TOKENS}/d{NEW_TOKENS} "
        f"{weights or quantize} weights + {kv} KV, "
        f"{'fresh' if fresh else 'streaming'} "
        f"prefill: {res.n_blocks - N} blocks generated; "
        f"warm-up run {warm_s:.2f} s; timed run {secs:.3f} s = "
        f"{generated / secs:.1f} tok/s (prefill included); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches, generated / secs


def phase_vanilla(cfg, params):
    """The baseline at the block model's B, prompt and new tokens (unpadded
    random prompts, as ``bench.py``): one warm-up run, then a timed run
    between launch-count resets. Returns (launches, tokens per second),
    counting B x 128 decode-step tokens as ``bench.py`` does."""
    torch.cuda.reset_peak_memory_stats()
    ids = torch.as_tensor(np.random.default_rng(0).integers(
        1, cfg.vocab_size, (BATCH, PROMPT_TOKENS)), dtype=torch.int32,
        device="cuda")

    def run():
        return pg.vanilla_generate(params, cfg, ids, NEW_TOKENS)

    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    reset_launches()
    with W8A8Decisions() as decisions:
        t0 = time.perf_counter()
        toks = run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    launches = read_launches("vanilla")
    trace_launches("vanilla", run)
    decisions.check("vanilla", launches,
                    (4 * cfg.num_layers, BATCH * PROMPT_TOKENS))
    if tuple(toks.shape) != (BATCH, NEW_TOKENS + 1):
        raise AssertionError(f"vanilla tokens shape {tuple(toks.shape)}")
    if int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size:
        raise AssertionError("vanilla tokens out of [0, vocab)")
    generated = BATCH * NEW_TOKENS
    log(f"{VANILLA_MODEL} greedy B={BATCH} p{PROMPT_TOKENS}/d{NEW_TOKENS} "
        f"int8 weights + int8 KV: warm-up run {warm_s:.2f} s; timed run "
        f"{secs:.3f} s = {generated / secs:.1f} tok/s (prefill included); "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches, generated / secs


def phase_engine(kind: str, cfg, params):
    """Serve the engine traffic at full width with the ``kind`` cache: a
    short warm-up, then one timed run between launch-count resets."""
    eng = pg.make_engine(params, cfg, kind)
    t0 = time.perf_counter()
    warm = pg.serve(eng, pg.engine_requests(cfg, ((2, 512, 8),), seed=1))
    log(f"engine {kind}: warm-up ({len(warm['requests'])} short requests) "
        f"{time.perf_counter() - t0:.2f} s")
    requests = pg.engine_requests(cfg, seed=0)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with W8A8Decisions() as decisions:
        res = pg.serve(eng, requests)
    launches = read_launches(f"engine {kind}")
    decisions.check(f"engine {kind}", launches)
    trace_launches(f"engine {kind}", lambda: pg.serve(eng, requests))
    reqs = res["requests"]
    early = 0
    for r, (_, budget) in zip(reqs, requests):
        if r.error or not r.done or not 1 <= len(r.generated) <= budget:
            raise AssertionError(f"engine {kind}: request {r.uid} served "
                                 f"{len(r.generated)} of {budget} tokens "
                                 f"(error {r.error!r})")
        if min(r.generated) < 0 or max(r.generated) >= cfg.vocab_size:
            raise AssertionError(f"engine {kind}: tokens out of [0, vocab)")
        early += len(r.generated) < budget      # ended at an EOS
    if kind.startswith("paged") and (
            [sorted(f) for f in eng._free_pages]
            != [list(range(1, eng.pool_pages))]
            or bool(eng.cache.page_table.any())):
        raise AssertionError(f"engine {kind}: pages were not all freed")
    lat = res["latency"]
    log(f"{MODEL} engine kv_cache={kind}: {len(reqs)} requests, 16 slots, "
        f"{res['tokens']} tokens in {res['seconds']:.3f} s = "
        f"{res['tokens'] / res['seconds']:.1f} tok/s (admission included); "
        f"engine_admit_s {res['admit_s']:.4f}; dispatches "
        f"{res['dispatches']}; {early} requests ended at an EOS; TTFT mean "
        f"{lat['ttft_s_mean']:.3f} s p50 {lat['ttft_s_p50']:.3f} s p95 "
        f"{lat['ttft_s_p95']:.3f} s; TPOT mean {lat['tpot_s_mean'] * 1e3:.2f} "
        f"ms p95 {lat['tpot_s_p95'] * 1e3:.2f} ms; queue wait mean "
        f"{lat['queue_wait_s_mean']:.3f} s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches, [r.generated for r in reqs]


def phase_cache_agreement(cfg, params):
    """One full-width decode step of the block decoder (INT8 weights, the
    engine's 16 slots, 3 pages of 256 slots a row) from identical prefilled
    K/V, through the contiguous stack and the paged one: INT8 (K5 fused
    writes, K2 attends) against the paged INT8 pool (K6 with the fresh
    term, K7 in the last layer's fused launch), and the contiguous INT4
    cache against the paged INT4 pool (K6 INT4).
    A random 512-position prefill fills the contiguous cache, K8 copies its
    pages into the pool; the step runs at ragged frontiers. Asserts that
    the outputs agree within TOL * max|out|."""
    dev, bf16 = "cuda", torch.bfloat16
    bcfg, bd = cfg.block_decoder, params["block_decoder"]
    B, ps, n_virt, S0 = ENGINE_B, pg.ENGINE_PAGE_SIZE, 3, 512
    cap, n = ps * n_virt, cfg.n_embedding_tokens
    g = torch.Generator(device=dev).manual_seed(12)
    x = torch.randn((B, S0, bcfg.hidden_size), generator=g, device=dev,
                    dtype=bf16)
    x_step = torch.randn((B, n, bcfg.hidden_size), generator=g, device=dev,
                         dtype=bf16)
    valid = torch.zeros((B, cap), dtype=torch.int32, device=dev)
    for b in range(B):
        valid[b, 8 * b:S0] = 1                 # left pad of 8*b positions
    prefill = masks.block_decode_mask(0, cap, S0, valid, n)
    wp = (S0 - 200 + 13 * torch.arange(B, device=dev)).to(torch.int32)
    step_valid = valid.clone()
    cols = torch.arange(cap, device=dev)[None]
    step_valid[cols >= wp[:, None]] = 0        # the rows' frontiers
    step_valid[cols == wp[:, None]] = 1        # the step's own slot
    step = masks.AttnMask((wp // n)[:, None].to(torch.int32),
                          (torch.arange(cap, device=dev) // n).to(torch.int32),
                          step_valid)
    positions = wp[:, None] + torch.arange(n, dtype=torch.int32, device=dev)
    pt = (1 + torch.randperm(B * n_virt, generator=g, device=dev)).reshape(
        B, n_virt).to(torch.int32)
    for bits in (8, 4):
        contig = neox.QuantKVCache.create(bcfg, B, cap, bits=bits, device=dev)
        _, contig = neox.neox_stack(bd, x, cfg=bcfg, mask=prefill,
                                    positions=torch.arange(
                                        S0, dtype=torch.int32, device=dev),
                                    cache=contig)
        paged = neox.PagedKVCache.create(bcfg, B, cap, n_pages=B * n_virt + 1,
                                         page_size=ps, bits=bits, device=dev)
        paged.page_table.copy_(pt)
        kp.paged_page_copy_int8(paged.k, paged.k_scale, paged.v,
                                paged.v_scale, pt, contig.k, contig.k_scale,
                                contig.v, contig.v_scale)
        outs = [neox.neox_stack(bd, x_step, cfg=bcfg, mask=step,
                                positions=positions, cache=c, write_pos=wp)[0]
                for c in (contig, paged)]
        for o in outs:
            if not bool(torch.isfinite(o).all()):
                raise AssertionError(f"cache agreement int{bits}: not finite")
        delta = (outs[0].float() - outs[1].float()).abs()
        diff, scale = delta.max().item(), outs[0].float().abs().max().item()
        name = "int8 vs paged" if bits == 8 else "int4 vs paged-int4"
        log(f"one block-decoder step from identical K/V, {name}: max |diff| "
            f"{diff:.4e}, max |out| {scale:.4e}, ratio {diff / scale:.3e} "
            f"(limit TOL {TOL}); mean |diff| {delta.mean().item():.4e}, mean "
            f"|out| {outs[0].float().abs().mean().item():.4e}, "
            f"{(delta > 0).float().mean().item():.3f} of outputs differ")
        if diff > TOL * scale:
            raise AssertionError(f"cache agreement {name}: {diff:.4e} > "
                                 f"{TOL} * {scale:.4e}")
        del contig, paged, outs


def log_agreement(a: str, b: str, x_tokens, y_tokens) -> None:
    """How far the greedy tokens of engine caches ``a`` and ``b`` agree."""
    pairs = [(p, q) for x, y in zip(x_tokens, y_tokens)
             for p, q in zip(x, y)]
    prefix = [next((i for i, (p, q) in enumerate(zip(x, y)) if p != q),
                   min(len(x), len(y)))
              for x, y in zip(x_tokens, y_tokens)]
    log(f"engine {a} vs {b}: the two caches agree on "
        f"{sum(p == q for p, q in pairs)} of {len(pairs)} tokens (bf16 "
        f"near-ties may differ); common prefix per request: min "
        f"{min(prefix)}, mean {np.mean(prefix):.1f} tokens, "
        f"{sum(p == len(x) for p, x in zip(prefix, x_tokens))} of "
        f"{len(prefix)} requests equal")


# the train phase: two sequences of 2048 tokens, float32 master weights, TF32
# off; 3 plain steps, then a QAT fine-tune of 3 steps with a fresh optimizer
TRAIN_SEQS, TRAIN_TOKENS, TRAIN_STEPS = 2, 2048, 3
TRAIN_LR = dict(peak_lr=1e-4, warmup_steps=1, total_steps=10)
QAT_RECIPE = "mixed48"
CARD_CPU_RTOL = 1e-5    # train steps, card against CPU, float32: loss,
                        # grad_norm, Adam's moments (each leaf, Frobenius)
UPDATE_RTOL = 1e-4      # each parameter leaf: |card - CPU| within
                        # CARD_CPU_RTOL |p0| + UPDATE_RTOL |update|, over the
                        # coordinates whose gradient is zero or above float32
NOISE_FLOOR = 1e-6      # noise, sqrt(nu) > NOISE_FLOOR * max sqrt(nu) (the
                        # CPU's nu): Adam turns a gradient that is zero in
                        # exact arithmetic (the key bias off RoPE's dims)
                        # into the sign of its rounding noise
GPTQ_EQUAL = 0.999      # gptq_round on one (W, H), card against CPU: share
                        # of Q equal, the rest one step apart
GPTQ_TREE_RTOL = 0.02   # whole GPTQ trees, card against CPU: mean layer-
                        # output error within 2% relative


def train_batch(cfg, seed: int, tokens: int = TRAIN_TOKENS,
                rows: int = TRAIN_SEQS):
    """The train step's batch (numpy): ``rows`` rows of random tokens, row 1
    left-padded by 96 tokens."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, cfg.vocab_size, (rows, tokens))
    att = np.ones_like(ids)
    ids[1, :96], att[1, :96] = 0, 0
    return packing.make_train_batch_from_rows(ids, att, cfg.block_length)


def calibration(batch):
    """A train batch as GPTQ's calibration batches (block format)."""
    return [(batch["input_ids"], batch["attention_mask"],
             batch["block_attention_mask"])]


def train_steps(cfg, state, tx, batch, n: int, transform, what: str):
    """``n`` train steps on the card, each timed (host clock, the device
    synchronized) with its peak memory and loss; asserts finite losses and
    that no kernel launched (K3 included: attention under autograd takes
    the plain path)."""
    step = ts.make_train_step(cfg, tx, param_transform=transform)
    dev_batch = packing.to_device(batch, CARD)
    tokens = dev_batch["input_ids"].numel()
    before = {tag: fn.launches for fn, tag, *_ in KERNELS}
    for _ in range(n):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, metrics = step(state, dev_batch)
        loss, norm = float(metrics["loss"]), float(metrics["grad_norm"])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        log(f"{MODEL} train step {state.step} ({what}, B={TRAIN_SEQS} x "
            f"{TRAIN_TOKENS} tokens, remat, float32, TF32 off): "
            f"{secs * 1e3:.1f} ms = {tokens / secs:.1f} tokens/s; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; loss "
            f"{loss:.6f}, grad_norm {norm:.6f}, lr "
            f"{tx.schedule(state.step - 1):.3e}")
        if not (math.isfinite(loss) and math.isfinite(norm)):
            raise AssertionError(f"train step {state.step} ({what}): loss "
                                 f"{loss}, grad_norm {norm}")
    after = {tag: fn.launches for fn, tag, *_ in KERNELS}
    moved = {t: after[t] - before[t] for t in after if after[t] != before[t]}
    log(f"kernel launches during the {what} train steps: {moved or 'none'} "
        f"(K3: {after['K3'] - before['K3']})")
    if moved:
        raise AssertionError(f"kernels launched under autograd: {moved}")
    return state


def phase_train_quantize(cfg):
    """The quantization workflow at full width: random float32
    ``block_main_b4_1.2b``, TRAIN_STEPS plain train steps, then TRAIN_STEPS
    QAT steps (``mixed48``) from a fresh optimizer; the QAT weights
    quantized with the recipe (RTN) and served; GPTQ INT4 g128 of the same
    weights, calibrated on the train batch, and served. Returns the
    launches of both generation runs."""
    tx, _ = opt.make_optimizer(**TRAIN_LR)
    t0 = time.perf_counter()
    state = ts.create_train_state(0, cfg, tx, device=CARD)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in opt.tree_leaves(state.params))
    log(f"{MODEL}: {n_params} float32 parameters and AdamW moments on the "
        f"card in {time.perf_counter() - t0:.2f} s")
    batch = train_batch(cfg, seed=0)
    state = train_steps(cfg, state, tx, batch, TRAIN_STEPS, None, "plain")
    state = ts.TrainState(state.params, None, 0)       # free the moments
    state = ts.TrainState(state.params, tx.init(state.params), 0)
    transform = functools.partial(quant.fake_quant_block_transformer,
                                  **quant.RECIPES[QAT_RECIPE])
    state = train_steps(cfg, state, tx, batch, TRAIN_STEPS, transform,
                        f"QAT {QAT_RECIPE}")
    params = state.params
    del state
    launches = {}
    qat = quant.cast_floats(quant.quantize_block_transformer(
        params, **quant.RECIPES[QAT_RECIPE]), torch.bfloat16)
    launches["QAT mixed48"], _ = phase_generation(
        cfg, qat, QAT_RECIPE, weights=f"QAT {QAT_RECIPE} (RTN of the "
        "fine-tuned weights)")
    del qat

    stats = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tree = gptq.gptq_quantize_block_transformer(
        params, cfg, calibration(batch), bits=4, group_size=GROUP_SIZE,
        device=CARD, stats=stats)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    log(f"GPTQ INT4 g{GROUP_SIZE} of {MODEL} on the card, calibrated on "
        f"{TRAIN_SEQS} x {TRAIN_TOKENS} tokens: {secs:.2f} s; " + ", ".join(
            f"{k} {v:.3f}" for k, v in stats.items() if k.endswith("_s")))
    L = cfg.block_decoder.num_layers
    ratios = []
    for e in stats["layer_errors"]:
        ratios.append(e["gptq"] / e["rtn"])
        if e["layer"] in (0, L - 1):
            log(f"  {e['trunk']} layer {e['layer']} {e['linear']} (K "
                f"{e['K']}, N {e['N']}): ||X(W - W_hat)|| / ||XW|| GPTQ "
                f"{e['gptq']:.5f}, RTN {e['rtn']:.5f}")
    log(f"GPTQ / RTN layer-output error over all {len(ratios)} linears of "
        f"both stacks: mean {np.mean(ratios):.4f}, max {max(ratios):.4f}")
    if not np.mean(ratios) < 1.0:
        raise AssertionError("GPTQ's layer-output error is not below RTN's")
    del params
    tree = quant.cast_floats(tree, torch.bfloat16)
    launches["GPTQ int4"], _ = phase_generation(
        cfg, tree, "int4", weights=f"GPTQ int4 g{GROUP_SIZE}")
    for what, n in launches.items():
        log(f"launches generating from the {what} tree: {json.dumps(n)}")
    return launches


def q_values(tree):
    """{path: int32 Q} of every quantized kernel (INT4 unpacked)."""
    out = {}
    for path, leaf in opt.tree_items(tree):
        if path[-1] == "kernel_q4":
            out[path] = quant.unpack_int4(leaf.cpu()).to(torch.int32)
        elif path[-1] == "kernel_q8":
            out[path] = leaf.cpu().to(torch.int32)
    return out


def train_state_error(p0, cpu, card) -> dict:
    """Card state against CPU state after the same steps from parameters
    ``p0`` ({path: tensor}): the largest over leaves of the relative
    Frobenius difference of Adam's moments ``mu`` and ``nu``, and of
    ``|p_card - p_cpu| / (CARD_CPU_RTOL |p0| + UPDATE_RTOL |p_cpu - p0|)``
    over the coordinates whose ``sqrt(nu)`` is zero or above NOISE_FLOOR
    of the leaf's largest (at most 1 passes)."""
    out = {"mu": 0.0, "nu": 0.0, "params": 0.0}
    for name in ("mu", "nu"):
        a = dict(opt.tree_items(getattr(cpu.opt_state, name)))
        b = dict(opt.tree_items(getattr(card.opt_state, name)))
        out[name] = max(float((b[k].cpu() - v).norm() / v.norm())
                        for k, v in a.items() if v.norm() > 0)
    nu = dict(opt.tree_items(cpu.opt_state.nu))
    p_cpu = dict(opt.tree_items(cpu.params))
    p_card = dict(opt.tree_items(card.params))
    for path, w0 in p0.items():
        rms = nu[path].sqrt()
        live = (rms == 0) | (rms > NOISE_FLOOR * rms.max())
        w, diff = p_cpu[path][live], (p_card[path].cpu() - p_cpu[path])[live]
        limit = (CARD_CPU_RTOL * w0[live].norm()
                 + UPDATE_RTOL * (w - w0[live]).norm())
        if diff.norm() > 0:
            out["params"] = max(out["params"], float(diff.norm() / limit))
    return out


def phase_small_train_gptq():
    """The train step and GPTQ on the card against the CPU (both the port,
    float32, TF32 off) at ``block_main_b4_5``: 2 steps (the first at lr 0),
    plain and QAT ``mixed48``: loss, grad_norm and Adam's moments within
    CARD_CPU_RTOL, the parameters as ``train_state_error`` states; GPTQ
    INT4 g128, calibrated on 8 sequences of 2048 tokens: ``gptq_round`` on
    one (W, H) on both devices, at least GPTQ_EQUAL of Q equal and the rest
    one step apart (cuSOLVER's inverse and Cholesky against LAPACK's), the
    differences counted; whole trees by their quality, the mean layer-
    output error within GPTQ_TREE_RTOL, their Q agreement logged. A row
    sweep carries each rounding that flips down its column, so a last-bit
    difference of the float32 calibration forward moves many entries, the
    more so where the calibration holds fewer positions than a linear has
    inputs (H singular but for the damping)."""
    cfg = config.get_config("block_main_b4_5")
    tx, _ = opt.make_optimizer(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    batch = train_batch(cfg, seed=6, tokens=256)
    params0 = ts.create_train_state(0, cfg, tx, device="cpu").params
    p0 = dict(opt.tree_items(params0))
    for recipe in (None, QAT_RECIPE):
        transform = None if recipe is None else functools.partial(
            quant.fake_quant_block_transformer, **quant.RECIPES[recipe])
        runs = []
        for dev in ("cpu", CARD):
            params = opt.tree_map(lambda t: t.to(dev, copy=True), params0)
            state = ts.TrainState(params, tx.init(params), 0)
            step = ts.make_train_step(cfg, tx, param_transform=transform)
            metrics = []
            for _ in range(2):
                state, m = step(state, packing.to_device(batch, dev))
                metrics.append([float(m["loss"]), float(m["grad_norm"])])
            runs.append((np.array(metrics), state))
        (m_cpu, s_cpu), (m_gpu, s_gpu) = runs
        m_err = float(np.max(np.abs(m_gpu - m_cpu) / np.abs(m_cpu)))
        err = train_state_error(p0, s_cpu, s_gpu)
        what = "plain" if recipe is None else f"QAT {recipe}"
        log(f"small train steps block_main_b4_5 ({what}), card vs CPU: "
            f"losses {m_gpu[:, 0].tolist()} / {m_cpu[:, 0].tolist()}, "
            f"grad_norms {m_gpu[:, 1].tolist()} / {m_cpu[:, 1].tolist()}; "
            f"max relative diff: loss/grad_norm {m_err:.3e}, mu "
            f"{err['mu']:.3e}, nu {err['nu']:.3e} (limit {CARD_CPU_RTOL}); "
            f"parameters {err['params']:.3f} of their limit")
        if max(m_err, err["mu"], err["nu"]) > CARD_CPU_RTOL or (
                err["params"] > 1.0):
            raise AssertionError(f"small train steps ({what}): card and CPU "
                                 "differ")
    calib = calibration(train_batch(cfg, seed=7, rows=8))
    # the rounding alone: gptq_round on one (W, H) on both devices, H from
    # the calibration's inputs to the block decoder's first qkv and MLP up
    ids, att, bam = (torch.from_numpy(a) for a in calib[0])
    n_emb, layers = cfg.n_embedding_tokens, params0["block_decoder"]["layers"]
    x = emb.embed_blocks(params0["embedder"], cfg.embedder, cfg.block_length,
                         ids, attention_mask=att).reshape(
        ids.shape[0], -1, cfg.embedder.projection_hidden_size)
    valid = torch.repeat_interleave(bam, n_emb, dim=1)
    for name, ln, w in (("qkv", "ln1", layers["attn"]["qkv"]["kernel"][0]),
                        ("up", "ln2", layers["mlp"]["up"]["kernel"][0])):
        H = gptq._gram(neox.layer_norm(x, {k: v[0] for k, v in
                                           layers[ln].items()},
                                       cfg.block_decoder.layer_norm_eps),
                       valid)
        q_cpu, s_cpu = gptq.gptq_round(w, H, bits=4, group_size=GROUP_SIZE)
        q_card, s_card = gptq.gptq_round(w.to(CARD), H.to(CARD), bits=4,
                                         group_size=GROUP_SIZE)
        diff = (q_card.cpu() - q_cpu).abs()
        s_err = float(((s_card.cpu() - s_cpu).abs() / s_cpu).max())
        log(f"small gptq_round block_main_b4_5 layer 0 {name} (K "
            f"{w.shape[0]}, N {w.shape[1]}), one H on both, card vs CPU: "
            f"{int((diff == 0).sum())} of {diff.numel()} Q equal, "
            f"{int((diff > 0).sum())} ties broken apart by cuSOLVER against "
            f"LAPACK, max |diff| {int(diff.max())}; scales max rel diff "
            f"{s_err:.3e}")
        if (diff == 0).float().mean() < GPTQ_EQUAL or diff.max() > 1:
            raise AssertionError(f"small gptq_round {name}: card and CPU "
                                 "differ")
    # whole trees: the calibration forward in float32 differs in its last
    # bits between the devices, and the row sweep carries each rounding
    # that flips down its column, so trees are compared by their quality
    stats = [{}, {}]
    trees = [q_values(gptq.gptq_quantize_block_transformer(
        params0, cfg, calib, bits=4, group_size=GROUP_SIZE, device=dev,
        stats=st)) for dev, st in zip(("cpu", CARD), stats)]
    n = equal = worst = 0
    for path, q_cpu in trees[0].items():
        diff = (trees[1][path] - q_cpu).abs()
        n, equal = n + diff.numel(), equal + int((diff == 0).sum())
        worst = max(worst, int(diff.max()))
    err = [{k: np.mean([e[k] for e in st["layer_errors"]])
            for k in ("gptq", "rtn")} for st in stats]
    log(f"small GPTQ int4 g{GROUP_SIZE} block_main_b4_5 (8 x 2048 "
        f"calibration tokens), card vs CPU trees: {equal} of {n} Q entries "
        f"equal ({equal / n:.6f}), max |diff| {worst}; mean layer-output "
        f"error GPTQ {err[1]['gptq']:.5f} / {err[0]['gptq']:.5f}, RTN "
        f"{err[1]['rtn']:.5f} / {err[0]['rtn']:.5f} (limit: GPTQ within "
        f"{GPTQ_TREE_RTOL} relative, below RTN)")
    if (abs(err[1]["gptq"] - err[0]["gptq"]) > GPTQ_TREE_RTOL * err[0]["gptq"]
            or not err[1]["gptq"] < err[1]["rtn"]):
        raise AssertionError("small GPTQ: the card's tree is not the CPU's "
                             "in quality")

# the trainer phase: the training loop through its entry points at full
# width (bf16 as the YAMLs say), then the tiny trainer card against CPU
BLOCK_YAML = "block_main_b4_1.2b"
VANILLA_YAML, UPTRAIN_YAML = "vanilla_160", "block_uptrain_b4_85_10"
SYNTHETIC_TOKENS = 200000   # the synthetic corpus: ~1000 random documents
RESUME_RTOL = 1e-3      # the resumed run's step-3 loss against the
                        # uninterrupted run's (bf16, the same parameters)
TRAINER_CPU_RTOL = 1e-4  # tiny trainer records, card against CPU, float32
TRAINER_DISK_BYTES = 30e9  # (a)'s 14.5 GB checkpoint, (b)'s two
RESUME_LAYERS = 4       # (b)'s depth a stack (full width), cut to fit the
                        # script's time


def launch_counts() -> dict:
    return {tag: fn.launches for fn, tag, *_ in KERNELS}


def assert_no_launch(before: dict, what: str) -> None:
    """No hand kernel launched since ``before``: training runs the plain
    paths under autograd, as JAX's trainer does under its mesh (Pallas off
    there)."""
    moved = {t: n - before[t] for t, n in launch_counts().items()
             if n != before[t]}
    log(f"kernel launches during {what}: {moved or 'none'}")
    if moved:
        raise AssertionError(f"kernels launched during {what}: {moved}")


def metrics_records(out_dir: str) -> list:
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def finite_records(recs: list, what: str) -> None:
    for r in recs:
        if not (math.isfinite(r["loss"])
                and math.isfinite(r.get("grad_norm", 0.0))):
            raise AssertionError(f"{what}: step {r['step']} record {r}")


def checkpoint_bytes(out_dir: str, step: int) -> int:
    path = os.path.join(out_dir, f"checkpoint-{step}")
    return sum(os.path.getsize(os.path.join(path, n))
               for n in os.listdir(path))


def cut_depth(cfg, layers: int):
    """``cfg`` at full width, ``layers`` a stack."""
    cut = lambda n: dataclasses.replace(n, num_layers=layers)  # noqa: E731
    return dataclasses.replace(
        cfg, block_decoder=cut(cfg.block_decoder),
        token_decoder=dataclasses.replace(
            cfg.token_decoder, neox=cut(cfg.token_decoder.neox)))


def phase_packer(smi: str) -> None:
    """The native packer (``csrc/packer.cpp`` built with g++) against the
    numpy mapping on the synthetic corpus at 2048-token samples."""
    from block_transformer_tpu_torch.pretrain_block_transformer import (
        synthetic_corpus)
    ds = packing.PackedDataset(
        synthetic_corpus(SYNTHETIC_TOKENS, 50304, 512), 2048, eos_token=0,
        pad_token=0, block_length=4)
    # the trainer's indices (mod len): the native packer wraps a window
    # that crosses the corpus end, the numpy mapping pads it
    idxs = np.arange(64) % len(ds)
    t0 = time.perf_counter()
    built = native_packer.get_packer() is not None
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    native = ds.get_batch(idxs)
    native_s = time.perf_counter() - t0
    route = ds.last_route
    t0 = time.perf_counter()
    plain = ds.get_batch(idxs, use_native=False)
    numpy_s = time.perf_counter() - t0
    same = all(np.array_equal(native[k], plain[k]) for k in plain)
    log(f"packer: native library {'built' if built else 'not built'} in "
        f"{build_s:.2f} s; 64 samples of 2048 tokens by the {route} route "
        f"{native_s * 1e3:.2f} ms, numpy {numpy_s * 1e3:.2f} ms (host); "
        f"equal: {same} [{smi}]")
    if not same:
        raise AssertionError("the native packer differs from numpy")


def phase_trainer_entry(work: str, smi: str) -> None:
    """(a) ``block_main_b4_1.2b`` through ``pretrain_block_transformer.main``
    with its YAML (bf16), a synthetic corpus, 2048-token samples, batch 2,
    2 steps; the step's wall time from ``metrics.jsonl``."""
    from block_transformer_tpu_torch import pretrain_block_transformer
    out = os.path.join(work, "entry")
    before = launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    t = pretrain_block_transformer.main([
        "--config", config_path(BLOCK_YAML), "--synthetic",
        str(SYNTHETIC_TOKENS), "--steps", "2", "--batch_size", "2",
        "--output_dir", out])
    secs = time.perf_counter() - t0
    assert_no_launch(before, "the entry point's train steps")
    recs = metrics_records(out)
    finite_records(recs, "entry point")
    last = recs[-1]
    tokens = t.micro_batch * t.tcfg.max_length
    dtypes = sorted({str(p.dtype) for p in opt.tree_leaves(t.state.params)})
    log(f"(a) {BLOCK_YAML} pretrain_block_transformer.main (YAML, "
        f"{dtypes}, B=2 x {t.tcfg.max_length}, remat): step {last['step']} "
        f"{last['wall_time_s']:.3f} s = {tokens / last['wall_time_s']:.1f} "
        f"tokens/s, loss {last['loss']:.5f}; main() {secs:.2f} s with init "
        f"and the step-2 checkpoint ({checkpoint_bytes(out, 2)} bytes); peak "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"[{smi}]")
    if t.state.step != 2 or dtypes != ["torch.bfloat16"]:
        raise AssertionError(f"entry point: step {t.state.step}, {dtypes}")
    del t
    shutil.rmtree(out)


def resumed_state_differences(got, want) -> list:
    """The leaves (and counters) of two ``TrainState``s that are not equal
    bit for bit, dtype included."""
    bad = [name for name, a, b in (
        ("step", got.step, want.step),
        ("count", got.opt_state.count, want.opt_state.count)) if a != b]
    for name, ta, tb in (("params", got.params, want.params),
                         ("mu", got.opt_state.mu, want.opt_state.mu),
                         ("nu", got.opt_state.nu, want.opt_state.nu)):
        b = dict(opt.tree_items(tb))
        for path, a in opt.tree_items(ta):
            if a.dtype != b[path].dtype:
                bad.append(f"{name}/{'/'.join(map(str, path))} "
                           f"{a.dtype} != {b[path].dtype}")
            elif not torch.equal(a, b[path]):
                d = (a.float() - b[path].float()).abs().max()
                bad.append(f"{name}/{'/'.join(map(str, path))} max abs "
                           f"difference {float(d):.3e}")
    return bad


def phase_trainer_resume(work: str, smi: str) -> None:
    """(b) The same model, cut to RESUME_LAYERS a stack at full width,
    through ``Trainer``: total batch 4 of micro 2
    (accumulation 2), ramp-up 1, 3 steps, saving at step 2; a second
    ``Trainer`` resumes from it to step 3, and its state equals the
    uninterrupted run's bit for bit (the moments too: the step-3 loss
    alone is computed before step 3's update)."""
    cfg = cut_depth(config_yaml.load_block_config_yaml(
        config_path(BLOCK_YAML)), RESUME_LAYERS)
    tkw = config_yaml.load_trainer_kwargs_yaml(config_path(BLOCK_YAML))
    out = os.path.join(work, "resume")
    tkw.update(output_dir=out, total_batch_size=4, micro_batch_size=2,
               batch_size_rampup_steps=1, stop_steps=3, save_steps=2,
               logging_steps=1)
    from block_transformer_tpu_torch.pretrain_block_transformer import (
        synthetic_corpus)
    T = tkw["max_length"]
    ds = packing.PackedDataset(
        synthetic_corpus(SYNTHETIC_TOKENS, cfg.vocab_size, 512), T,
        eos_token=0, pad_token=0, block_length=cfg.block_length)
    before = launch_counts()
    torch.cuda.reset_peak_memory_stats()
    first = trainer_lib.Trainer(cfg, trainer_lib.TrainerConfig(**tkw), ds,
                                device=CARD)
    first.train()
    peak = torch.cuda.max_memory_allocated() / 2**30
    recs = metrics_records(out)
    finite_records(recs, "uninterrupted run")
    for r in recs:
        tokens = first._effective_accum(r["step"] - 1) * 2 * T
        log(f"(b) {BLOCK_YAML} at {RESUME_LAYERS} + {RESUME_LAYERS} layers "
            f"Trainer step {r['step']} (bf16, "
            f"{tokens // T} x {T} tokens, accumulation "
            f"{first._effective_accum(r['step'] - 1)}): {r['wall_time_s']:.3f}"
            f" s = {tokens / r['wall_time_s']:.1f} tokens/s; loss "
            f"{r['loss']:.6f}, grad_norm {r['grad_norm']:.5f} [{smi}]")
    saves = [e for e in first.checkpoint_log if e["op"] == "save"]
    nbytes = checkpoint_bytes(out, 2)
    moments = sorted({str(t.dtype) for t in opt.tree_leaves(
        first.state.opt_state.mu)})
    log(f"(b) peak memory {peak:.2f} GiB; checkpoint {nbytes} bytes "
        f"(bf16 params, {moments} moments): save "
        + ", ".join(f"step {e['step']} {e['s']:.2f} s "
                    f"({nbytes / e['s'] / 1e9:.2f} GB/s)" for e in saves)
        + f" [{smi}]")
    # the uninterrupted step-3 state stays on the card (~6.4 GB) for the
    # exact comparison below
    want_state = first.state
    del first
    torch.cuda.empty_cache()
    shutil.rmtree(os.path.join(out, "checkpoint-3"))
    os.rename(os.path.join(out, "metrics.jsonl"),
              os.path.join(work, "uninterrupted.jsonl"))
    second = trainer_lib.Trainer(cfg, trainer_lib.TrainerConfig(**tkw), ds,
                                 device=CARD)
    second.train(resume=True)
    assert_no_launch(before, "the Trainer's steps and resume")
    restore = second.checkpoint_log[0]
    got = metrics_records(out)[-1]
    want = recs[-1]
    err = abs(got["loss"] - want["loss"]) / abs(want["loss"])
    log(f"(b) resumed from step {restore['step']} (restore "
        f"{restore['s']:.2f} s = {nbytes / restore['s'] / 1e9:.2f} GB/s): "
        f"step {got['step']} {got['wall_time_s']:.3f} s, loss "
        f"{got['loss']:.6f} against the uninterrupted {want['loss']:.6f} "
        f"(relative {err:.2e}, limit {RESUME_RTOL}) [{smi}]")
    differ = resumed_state_differences(second.state, want_state)
    log(f"(b) resumed step-3 state against the uninterrupted one, bit for "
        f"bit (params, mu, nu, count, step): "
        f"{differ or 'equal'} [{smi}]")
    if restore["op"] != "restore" or got["step"] != 3 or err > RESUME_RTOL \
            or differ:
        raise AssertionError("the resumed run differs from the "
                             "uninterrupted one")
    del second, want_state
    torch.cuda.empty_cache()
    shutil.rmtree(out)


def phase_trainer_uptrain(work: str, smi: str) -> None:
    """(c) ``vanilla_160`` through ``pretrain_vanilla_transformer.main``
    (2 steps, batch 2 x 2048, float32 as the JAX script trains it), its
    checkpoint's parameters partitioned into ``block_uptrain_b4_85_10``
    (6 + 6 x 768) with the YAML's ``load_from_vanilla`` options and the
    computed token-decoder embeddings, cast to the YAML's bf16, and 2 block
    train steps from there."""
    from block_transformer_tpu_torch import pretrain_vanilla_transformer
    from block_transformer_tpu_torch.pretrain_block_transformer import (
        synthetic_corpus)
    from block_transformer_tpu_torch.train import uptrain
    from block_transformer_tpu_torch.utils import checkpoint as ckpt
    vout = os.path.join(work, "vanilla")
    before = launch_counts()
    t0 = time.perf_counter()
    vt = pretrain_vanilla_transformer.main([
        "--config", config_path(VANILLA_YAML), "--synthetic", str(SYNTHETIC_TOKENS), "--steps", "2",
        "--max_length", "2048", "--batch_size", "2", "--output_dir", vout])
    secs = time.perf_counter() - t0
    recs = metrics_records(vout)
    finite_records(recs, "vanilla")
    log(f"(c) {VANILLA_YAML} pretrain_vanilla_transformer.main (float32, "
        f"B=2 x 2048): step {recs[-1]['step']} {recs[-1]['wall_time_s']:.3f}"
        f" s, loss {recs[-1]['loss']:.5f}; main() {secs:.2f} s [{smi}]")
    vcfg = vt.model_cfg
    del vt
    vp = opt.tree_map(lambda t: t.to(torch.bfloat16),
                      ckpt.restore_params(vout, 2, device=CARD))
    cfg = config_yaml.load_block_config_yaml(config_path(UPTRAIN_YAML))
    # the YAML's concat embedder (hidden 192) cannot take vanilla_160's
    # [V, 768] table, in JAX as here; its load_from_vanilla options ask for
    # the mean projection, which is a projection layer over tokens of the
    # vanilla width
    cfg = dataclasses.replace(cfg, embedder=dataclasses.replace(
        cfg.embedder, hidden_size=vcfg.hidden_size,
        projection_method="projection_layer"))
    stanza = config_yaml.read_yaml(config_path(UPTRAIN_YAML))[
        "load_from_vanilla"]
    tkw = config_yaml.load_trainer_kwargs_yaml(config_path(UPTRAIN_YAML))
    bout = os.path.join(work, "uptrain")
    tkw.update(output_dir=bout, total_batch_size=2, micro_batch_size=None,
               stop_steps=2, logging_steps=1)
    ds = packing.PackedDataset(
        synthetic_corpus(SYNTHETIC_TOKENS, cfg.vocab_size, 512),
        tkw["max_length"], eos_token=0, pad_token=0,
        block_length=cfg.block_length)
    bt_trainer = trainer_lib.Trainer(cfg, trainer_lib.TrainerConfig(**tkw),
                                     ds, device=CARD)
    t0 = time.perf_counter()
    params = uptrain.load_block_from_vanilla(
        bt_trainer.state.params, cfg, vp, vcfg, method=stanza["method"],
        initialize_mean_embedder_projection=stanza[
            "initialize_mean_embedder_projection"],
        initialize_identity_expansion_layer=stanza[
            "initialize_identity_expansion_layer"],
        compute_token_decoder_embeddings=True)
    torch.cuda.synchronize()
    up_s = time.perf_counter() - t0
    del vp
    bt_trainer.state = ts.TrainState(
        params, bt_trainer.tx.init(params), 0)
    bt_trainer.train()
    assert_no_launch(before, "the vanilla run, the uptraining init (the "
                     "block decoder over [V, 1, h]: Q = 1 takes the plain "
                     "attention) and the uptrained steps")
    recs = metrics_records(bout)
    finite_records(recs, "uptrained")
    bd, td = cfg.block_decoder, cfg.token_decoder.neox
    log(f"(c) uptrained ({stanza['method']}, mean projection, identity "
        f"expansion, computed embeddings: {up_s:.2f} s) into {UPTRAIN_YAML} "
        f"({bd.num_layers} + {td.num_layers} x {bd.hidden_size}, "
        f"projection-layer embedder of {cfg.embedder.hidden_size}, bf16): "
        f"losses "
        + ", ".join(f"step {r['step']} {r['loss']:.5f} "
                    f"({r['wall_time_s']:.3f} s)" for r in recs)
        + f" [{smi}]")
    del bt_trainer, params
    torch.cuda.empty_cache()
    shutil.rmtree(vout)
    shutil.rmtree(bout)


def phase_trainer_small(work: str) -> None:
    """(d) The tiny trainer (hidden 64, one layer, vocab 96, 32-token
    samples; accumulation 2, ramp-up 2) for 3 steps on the card and on the
    CPU from the same initial state, float32: every record within
    TRAINER_CPU_RTOL."""
    cfg = config.make_block_config("tiny", block_decoder_hidden=64,
                                   block_decoder_layers=1, vocab_size=96,
                                   max_length=32)
    from block_transformer_tpu_torch.pretrain_block_transformer import (
        synthetic_corpus)
    ds = packing.PackedDataset(
        synthetic_corpus(8000, 96, 64), 32, eos_token=0, pad_token=0,
        block_length=4)
    runs = []
    state0 = None
    for i, dev in enumerate(("cpu", CARD)):
        tcfg = trainer_lib.TrainerConfig(
            output_dir=os.path.join(work, f"small_{i}"), learning_rate=3e-3,
            num_train_steps=12, stop_steps=3, num_warmup_steps=1,
            total_batch_size=8, micro_batch_size=4, batch_size_rampup_steps=2,
            max_length=32, logging_steps=1, remat=False)
        t = trainer_lib.Trainer(cfg, tcfg, ds, device=dev)
        if state0 is None:
            state0 = t.state
        params = opt.tree_map(lambda p: p.to(dev, copy=True), state0.params)
        t.state = ts.TrainState(params, t.tx.init(params), 0)
        t.train()
        runs.append(metrics_records(tcfg.output_dir))
    cpu, card = runs
    worst = 0.0
    for a, b in zip(cpu, card):
        if (a["step"], a["tokens_seen"], a["lr"]) != (
                b["step"], b["tokens_seen"], b["lr"]):
            raise AssertionError(f"small trainer records: {a} / {b}")
        for k in ("loss", "token_decoding_loss", "grad_norm",
                  "loss_by_position"):
            x, y = np.asarray(a[k]), np.asarray(b[k])
            worst = max(worst, float(np.max(np.abs(y - x) / np.abs(x))))
    log(f"(d) tiny trainer 3 steps card vs CPU (float32, TF32 off): losses "
        f"{[r['loss'] for r in card]} / {[r['loss'] for r in cpu]}; max "
        f"relative diff of loss, "
        f"grad_norm, loss_by_position {worst:.3e} (limit "
        f"{TRAINER_CPU_RTOL})")
    if len(card) != 3 or worst > TRAINER_CPU_RTOL:
        raise AssertionError("small trainer: card and CPU differ")


def phase_trainer(smi: str) -> None:
    """The training loop at full width (a)-(c) and card against CPU (d),
    with the packer; checkpoints under a temporary directory of the
    checkout's ``build/``, removed afterwards."""
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_trainer_",
                            dir=os.path.join(ROOT, "build"))
    try:
        free = shutil.disk_usage(work).free
        log(f"trainer phase: {free / 1e9:.1f} GB free under {work}")
        if free < TRAINER_DISK_BYTES:
            raise RuntimeError(
                f"the trainer phase holds up to 20 GB of checkpoints at once "
                f"and needs {TRAINER_DISK_BYTES / 1e9:.0f} GB free under "
                f"{work}; {free / 1e9:.1f} GB are")
        phase_packer(smi)
        phase_trainer_small(work)
        phase_trainer_entry(work, smi)
        phase_trainer_resume(work, smi)
        phase_trainer_uptrain(work, smi)
    finally:
        shutil.rmtree(work, ignore_errors=True)


# ---------------------------------------------------------------------------
# evaluation (phase_eval)
# ---------------------------------------------------------------------------

EVAL_BATCH, EVAL_MAX_LENGTH = 8, 2048
FEWSHOT = 5             # the few-shot TriviaQA's shots, drawn from the docs
                        # past the evaluated 8
FIXTURES = os.path.join(ROOT, "assets", "real_tasks")
HAYSTACK = os.path.join(ROOT, "assets", "needle_haystack.txt")
EXPORT_DISK_BYTES = 12e9   # the full-width tree in float32 (5.8 GB) twice over
# card against CPU in float32, relative, on a loglikelihood sum or a metric:
# the kernels' float32 results differ from the plain versions' only in the
# order of their sums (measured 9.4e-8 at the small configuration); a wrong
# kernel moves a random-init sum of ~ -n ln 512 by far more
EVAL_F32_TOL = 1e-5
# max |kernel - plain| / max|plain| of K3's float32 route: 3xTF32 keeps ~2^-22
# of each product and sums in rounded float32 adds (measured ~1e-6 at the
# scoring forward); one TF32 pass keeps ~2^-11, ~1e-4 of the output, which
# bf16's TOL would pass and this refuses
K3_F32_TOL = 1e-5
ENTRY_LIMIT = 8            # docs of each byte task through the entry point
# an uptraining config (3 + 3 layers of 256, 8 heads) whose projection-layer
# embedder takes the vanilla_31 table
FROM_VANILLA_YAML = """\
name: uptrain_from_vanilla_31
block_length: 4
total_batch_size: 2
per_device_train_batch_size: 1
max_length: 32
embedder:
  cls: lookup
  n_embedding_tokens: 1
  projection_method: projection_layer
  config: {vocab_size: 50304, hidden_size: 256}
block_decoder:
  cls: gpt-neo-x
  config: {num_hidden_layers: 3, hidden_size: 256, num_attention_heads: 8}
token_decoder:
  cls: gpt-neo-x
  expansion_method: expansion_layer
  expansion_ratio: 2
  decoding_strategy: prefix
  config: {num_hidden_layers: 3, hidden_size: 256, num_attention_heads: 8}
learning_rate: 6e-4
precision: fp32
num_train_steps: 10
num_warmup_steps: 1
save_steps: 100
logging_steps: 1
"""


def fixture(name: str, n: int) -> list:
    with open(os.path.join(FIXTURES, f"{name}.jsonl")) as f:
        return [json.loads(line) for line in f][:n]


class Counting:
    """An LM adapter mixin counting the requests and scored continuation
    tokens of a task."""

    def reset(self):
        self.requests, self.tokens = 0, 0

    def _loglikelihood_tokens(self, requests):
        self.requests += len(requests)
        self.tokens += sum(len(c) for _, c in requests)
        return super()._loglikelihood_tokens(requests)

    def generate_until(self, requests):
        self.requests += len(requests)
        return super().generate_until(requests)


class CountingBlockLM(Counting, eval_adapters.BlockTransformerLM):
    pass


class CountingVanillaLM(Counting, eval_adapters.VanillaLM):
    pass


class ScoringBatches:
    """Records the (B, S, lengths) of every scoring batch that a
    ``BlockTransformerLM`` runs inside, whoever built it."""

    def __enter__(self):
        self.seen, self._fn = [], eval_adapters.BlockTransformerLM._logits_fn

        def fn(lm, inps, lengths):
            self.seen.append((*inps.shape, lengths.cpu()))
            return self._fn(lm, inps, lengths)

        eval_adapters.BlockTransformerLM._logits_fn = fn
        return self

    def __exit__(self, *exc):
        eval_adapters.BlockTransformerLM._logits_fn = self._fn


class FewshotTriviaQA(eval_tasks.TriviaQA):
    """TriviaQA with FEWSHOT exemplars before each question
    (``samplers.build_fewshot_context``, drawn from ``pool``)."""

    name = f"triviaqa_{FEWSHOT}shot"

    def __init__(self, docs, pool):
        super().__init__(docs=docs)
        self._plain = eval_tasks.TriviaQA(docs=pool)
        self._sampler = eval_samplers.FewshotSampler(pool)

    def doc_to_text(self, doc):
        return eval_samplers.build_fewshot_context(self._plain, doc, FEWSHOT,
                                                   self._sampler)


def eval_path(lm, task_list, path: str, smi: str):
    """Each task through ``harness.evaluate`` between one launch-count
    reset and the path's check: seconds, requests/s and scored tokens/s
    each, metrics finite. Returns (launches, {task: results})."""
    torch.cuda.synchronize()
    reset_launches()
    results = {}
    with W8A8Decisions() as decisions:
        for task in task_list:
            lm.reset()
            t0 = time.perf_counter()
            res = eval_harness.evaluate(lm, [task])["results"][task.name]
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            if not all(math.isfinite(v) for v in res.values()):
                raise AssertionError(f"{path} {task.name}: {res}")
            results[task.name] = res
            log(json.dumps({
                "eval_task": task.name, "path": path,
                "docs": len(task.docs()), "s": secs,
                "requests": lm.requests, "requests_per_s": lm.requests / secs,
                "scored_tokens": lm.tokens,
                "scored_tokens_per_s": lm.tokens / secs,
                "metrics": res, "note": "random weights: the metrics prove "
                "the path, not the model's quality", "card": smi}))
    launches = read_launches(path)
    decisions.check(path, launches)
    return launches, results, decisions


def scoring_linear_rows(cfg, batches):
    """(M of the LM head, M of the token decoder's linears) in the scoring
    forward of the longest batch (B rows of S tokens, the adapter's left
    pad of L - 1 and right pad to a block boundary: N blocks, of which the
    token decoder takes N - 1)."""
    B, S, _ = max(batches, key=lambda b: b[1])
    L = cfg.block_length
    left = L - 1
    N = (S + left + ((-(S + left)) % L or L)) // L
    Bb = B * (N - 1)
    return Bb * L, Bb * (cfg.n_expanded_emb + L - 1)


def k4_f32_row(rows, g, label, M, K, N, layers, path, iters, slow_iters,
               group=GROUP_SIZE):
    """K4 with float32 x [M, K] @ an INT4 [layers, K/2, N] stack (groups of
    ``group`` rows) by its TF32 route, within K14_F32_TOL of its plain
    version, beside its CUDA-core kernel at the same inputs (``fma_ms``)
    and ``torch.matmul`` on the dequantized float32 layer, cycling through
    the layers; the plain version and the CUDA-core kernel ``slow_iters``
    times. Bound at F32_X_INT_FLOPS, the route's own two-pass TF32 bound
    beside it (``tf32x2_bound_ms``)."""
    dev = CARD
    w_p, scale = quant.quantize_int4(torch.randn(
        (layers, K, N), generator=g, device=dev) * 0.02, group)
    G = scale.shape[1]
    gs = K // G
    x = torch.randn((M, K), generator=g, device=dev)
    p = matmul_plan(M, K // 2, N, torch.float32, gs)
    before = dict(k1.int4_matmul_stacked.route_launches)
    got = k1.int4_matmul_stacked(x, w_p, scale, layers - 1)
    if routes_since(k1.int4_matmul_stacked, before)[p.route] != 1 or \
            p.route != "tf32x2":
        raise AssertionError(f"K4 {label}: not the tf32x2 route ({p})")
    want = k1.int4_matmul_stacked_plain(x, w_p, scale, layers - 1)
    err, pmax = compare(f"K4 {label}", got, want, K14_F32_TOL)
    ints = (K // 2, N, gs)
    fma_err, _ = compare(f"K4 {label} fma", matmul_fma(
        "int4_matmul", x, w_p, scale, layers - 1, ints), want, K14_F32_TOL)
    del got, want
    it = iter(range(10 ** 9))
    nxt = lambda: next(it) % layers          # noqa: E731
    ms, host_us = time_ms_host(
        lambda: k1.int4_matmul_stacked(x, w_p, scale, nxt()), iters)
    fma_ms = time_ms(lambda: matmul_fma("int4_matmul", x, w_p, scale, nxt(),
                                        ints), slow_iters)
    plain_ms = time_ms(lambda: k1.int4_matmul_stacked_plain(
        x, w_p, scale, nxt()), slow_iters)
    w_deq = [quant.dequantize_int4(w_p[i], scale[i], torch.float32)
             for i in range(layers)]
    lib_ms = time_ms(lambda: torch.matmul(x, w_deq[nxt()]), iters)
    del w_deq
    nbytes = M * K * 4 + K * N // 2 + G * N * 4 + M * N * 4
    record(rows, "K4", f"{label} G={G}", err, ms, plain_ms, lib_ms, nbytes,
           2 * M * K * N, p, host_us, path=path, peak=F32_X_INT_FLOPS,
           plain_max=pmax, extra={
               "fma_ms": fma_ms, "fma_max_abs_err": fma_err,
               "tf32x2_bound_ms": bound(nbytes, 2 * M * K * N,
                                        TF32X2_FLOPS)[0],
               "allow_tf32": torch.backends.cuda.matmul.allow_tf32})


def eval_kernel_rows(rows, cfg, batches, decisions, path="eval score",
                     dtype=torch.bfloat16):
    """The kernels at the scoring forward's new shapes, from its longest
    batch (B rows of S tokens, the adapter's left pad of L - 1 and right
    pad to a block boundary), in ``dtype``, the activations' (bf16, or
    float32: K3's 3xTF32 route, held within K3_F32_TOL and beside its
    CUDA-core kernel at the same inputs): K3 over the block decoder's N
    blocks under the forward's block-causal mask (rows past their content
    masked; the last 128-query tile partial), W8A8-q/-mm at the LM head (M
    = B (N-1) L, N = vocab: a partial last 256-column tile) and at the
    token decoder's mlp_up (M = B (N-1) (n_exp + L - 1)). Asserts that
    ``path`` took W8A8 at these M."""
    dev, bf16 = CARD, torch.bfloat16
    f32 = dtype == torch.float32
    g = torch.Generator(device=dev).manual_seed(15)
    B, S, lengths = max(batches, key=lambda b: b[1])
    L, n = cfg.block_length, cfg.n_embedding_tokens
    left = L - 1
    right = (-(S + left)) % L or L
    N = (S + left + right) // L
    pos = torch.arange(N * L)[None]
    att = (pos >= left) & (pos < left + lengths[:, None])
    att[torch.arange(B), left + lengths.long()] = True
    bam = att.reshape(B, N, L).any(-1).to(torch.int32).to(dev)
    mask = masks.block_decoder_train_mask(bam, n)
    bcfg, tcfg = cfg.block_decoder, cfg.token_decoder.neox
    H, D, Q = bcfg.num_heads, bcfg.head_dim, N * n
    qkv = [tuple(torch.randn((B, H, Q, D), generator=g, device=dev,
                             dtype=dtype) for _ in range(3))
           for _ in range(3)]
    kind = "float32 " if f32 else ""
    k3_row(rows, f"{kind}scoring forward B={B} H={H} Q=K={Q} D={D}, rows "
           f"of {lengths.min().item()}-{lengths.max().item()} tokens", qkv,
           mask, 20, 3, path=path, route="tf32x3" if f32 else "tc",
           peak=TF32X3_FLOPS if f32 else BF16_FLOPS,
           tol=K3_F32_TOL if f32 else TOL, fma=f32)
    del qkv
    m_head, m_td = scoring_linear_rows(cfg, batches)
    taken = {m for m, t in decisions.seen if t}
    if not {m_head, m_td, B * Q} <= taken:
        raise AssertionError(f"{path}: W8A8 at M {sorted(taken)}, not at "
                             f"the head's {m_head}, the token decoder's "
                             f"{m_td} and the block decoder's {B * Q}")
    w8a8_rows(rows, g, f"{kind}scoring lm_head", m_head, tcfg.hidden_size,
              tcfg.vocab_size, 1, path, dtype)
    w8a8_rows(rows, g, f"{kind}scoring token decoder mlp_up", m_td,
              tcfg.hidden_size, tcfg.intermediate_size, tcfg.num_layers,
              path, dtype)


def phase_eval_export(cfg, params, smi) -> None:
    """(d) The full-width bf16 tree through ``export_block_transformer``
    (float32 safetensors, the port's writer) into a temporary directory of
    ``build/``, read back by ``torch_import.load_checkpoint`` onto the card
    in bf16: every leaf equal bit for bit."""
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_export_",
                            dir=os.path.join(ROOT, "build"))
    try:
        free = shutil.disk_usage(work).free
        if free < EXPORT_DISK_BYTES:
            raise RuntimeError(f"the export needs {EXPORT_DISK_BYTES / 1e9:.0f}"
                               f" GB free under {work}; {free / 1e9:.1f} GB "
                               "are")
        t0 = time.perf_counter()
        torch_export.export_block_transformer(params, cfg, work)
        write_s = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(os.path.join(d, f))
                     for d, _, fs in os.walk(work) for f in fs)
        t0 = time.perf_counter()
        back = torch_import.load_checkpoint(work, cfg, dtype=torch.bfloat16,
                                            device=CARD)
        torch.cuda.synchronize()
        read_s = time.perf_counter() - t0
        got, want = dict(opt.tree_items(back)), dict(opt.tree_items(params))
        bad = sorted(set(got) ^ set(want)) or [
            k for k in want if got[k].dtype != want[k].dtype
            or not torch.equal(got[k], want[k])]
        if bad:
            raise AssertionError(f"export / import: leaves differ: {bad[:4]}")
        log(f"(d) {MODEL} bf16 ({bt.count_params(params)} parameters) "
            f"exported to the HF layout: {nbytes} bytes (float32) written in "
            f"{write_s:.2f} s, read back to the card in {read_s:.2f} s; "
            f"{len(want)} leaves equal bit for bit [{smi}]")
        del back
    finally:
        shutil.rmtree(work, ignore_errors=True)


def phase_eval_longctx(smi) -> dict:
    """(c) ``eval_longctx.main`` at full width (random bf16 weights): ppl
    over 2 synthetic docs (4 chunks of 2048, one batch of 4), then needle
    over ``assets/needle_haystack.txt`` at depths 0, 50 and 100 (3
    templates each, 2048-token prompts, 16 new tokens, byte tokenizer).
    Returns {path: launches}."""
    out = {}
    for path, argv in (
            ("eval longctx ppl", ["ppl", "--synthetic-docs", "2"]),
            ("eval longctx needle", ["needle", "--haystack", HAYSTACK,
                                     "--depths", "0,50,100", "--tokenizer",
                                     "byte"])):
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        res = eval_longctx.main(argv + ["--model", MODEL, "--random",
                                        "--context", "2048"])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        out[path] = read_launches(path)
        if path == "eval longctx ppl":
            ok = (res["n_chunks"] == 4 and math.isfinite(res["mean_loss"])
                  and len(res["loss_by_position"]) == 2048 - 4)
            what = f"{res['n_chunks']} chunks, mean loss {res['mean_loss']}"
        else:
            scores = res["scores_by_depth"]
            ok = sorted(scores) == [0.0, 50.0, 100.0] and all(
                0.0 <= v <= 1.0 for v in scores.values())
            what = f"retrieval by depth {scores}"
        if not ok:
            raise AssertionError(f"{path}: {res}")
        log(f"(c) {path}: eval_longctx.main {secs:.2f} s with the random "
            f"init; {what} (random weights: no measure of quality) [{smi}]")
        torch.cuda.empty_cache()
    return out


def eval_small_rows(rows, cfg):
    """The rows that count the launches of (f)'s float32 card run (``eval
    small``): K3 by its CUDA-core route at the small configuration's head
    dim (no full-width path takes it), at the adapter's scoring forward
    there (max_length 256: B = 4 rows of N = 65 blocks, block-causal), and
    K1 by its TF32 route at a decode shape of MODEL (qkv, M = 8) beside its
    CUDA-core kernel."""
    g = torch.Generator(device=CARD).manual_seed(16)
    bcfg = cfg.block_decoder
    B, H, D = 4, bcfg.num_heads, bcfg.head_dim
    N = 256 // cfg.block_length + 1
    mask = masks.block_decoder_train_mask(
        torch.ones((B, N), dtype=torch.int32, device=CARD),
        cfg.n_embedding_tokens)
    qkv = [tuple(torch.randn((B, H, N, D), generator=g, device=CARD)
                 for _ in range(3)) for _ in range(3)]
    k3_row(rows, f"small float32 scoring forward B={B} H={H} Q=K={N} "
           f"D={D}", qkv, mask, 50, 20, path="eval small", route="fma",
           peak=TF32X3_FLOPS, tol=K3_F32_TOL)
    big = config.get_config(MODEL).block_decoder
    k1_row(rows, g, "float32 qkv M=8", 8, big.hidden_size,
           3 * big.hidden_size, 12, path="eval small", dtype=torch.float32)


def small_card_vs_cpu(cfg, qparams, what: str) -> None:
    """The block adapter on ``qparams`` on the card against the CPU (W8A8's
    plain versions where the card takes W8A8, through the card gate opened
    for it): 8 lambada loglikelihoods and 1 wikitext page's rolling windows
    within EVAL_F32_TOL relative with equal greedy flags, and 4 TriviaQA
    generations equal."""
    tok = ByteTokenizer()
    reqs = [(d["text"].rsplit(" ", 1)[0], " " + d["text"].rsplit(" ", 1)[1])
            for d in fixture("lambada_pg", 8)]
    page = [d["page"] for d in fixture("wikitext_pg", 1)]
    trivia = eval_tasks.TriviaQA(docs=fixture("trivia_real", 4))
    greqs = [r[1] for d in trivia.docs() for r in trivia.build_requests(d)]
    out = []
    for params, on_card in ((qparams, False), (to_card(qparams), True)):
        lm = eval_adapters.BlockTransformerLM(params, cfg, tok,
                                              max_length=256, batch_size=4)
        gate = linear_ops._on_card
        if not on_card:
            linear_ops._on_card = lambda x: True
        try:
            out.append((lm.loglikelihood(reqs),
                        lm.loglikelihood_rolling(page),
                        lm.generate_until(greqs)))
        finally:
            linear_ops._on_card = gate
    (cpu_ll, cpu_roll, cpu_gen), (card_ll, card_roll, card_gen) = out
    worst = max(abs(a - b) / abs(b) for a, b in
                [(x[0], y[0]) for x, y in zip(card_ll, cpu_ll)]
                + list(zip(card_roll, cpu_roll)))
    if worst > EVAL_F32_TOL or [g for _, g in card_ll] != [
            g for _, g in cpu_ll] \
            or card_gen != cpu_gen:
        raise AssertionError(f"eval small {what}: card and CPU differ: "
                             f"{card_ll} / {cpu_ll}, {card_roll} / "
                             f"{cpu_roll}, {card_gen} / {cpu_gen}")
    log(f"(f) small adapter card vs CPU ({what}, float32): 8 "
        f"loglikelihoods and {len(page)} rolling page, max relative diff "
        f"{worst:.3e} (limit {EVAL_F32_TOL}), greedy flags equal; "
        f"{len(greqs)} generations equal")


def phase_eval_small(rows, smi) -> dict:
    """(f) The block adapter on the card against the CPU at the small
    configuration in float32 (``small_card_vs_cpu``), with INT8 weights and
    then INT4 (``--quantize int4``'s groups of 128, one group where a
    weight has fewer rows); K3's, K1's and K4's routes on the card are
    logged and checked (head dim 32: K3's CUDA-core route; float32 x in the
    TF32 envelope: K1's and K4's TF32 route), and ``eval_small_rows``
    counts their launches. Then ``--from_vanilla`` on the card: a random
    ``vanilla_31`` tree in the HF layout (a directory named after its
    config) uptrained into FROM_VANILLA_YAML (``partition``), one step.
    Returns {"eval small": {"K1": launches, "K3": launches, "K4":
    launches}}."""
    from block_transformer_tpu_torch import pretrain_block_transformer
    cfg, q8 = small_config()
    _, q4 = small_config(bits=4)
    before = {fn: dict(fn.route_launches) for fn in (
        k1.int8_matmul_stacked, k1.int4_matmul_stacked, k3.flash_attention)}
    small_card_vs_cpu(cfg, q8, "INT8")
    small_card_vs_cpu(cfg, q4, "INT4")
    k3_routes = check_k3_routes("(f) small adapter on the card",
                                before[k3.flash_attention],
                                cfg.block_decoder.head_dim)
    mm_routes = {tag: routes_since(fn, before[fn]) for tag, fn in (
        ("K1", k1.int8_matmul_stacked), ("K4", k1.int4_matmul_stacked))}
    log(f"(f) small adapter on the card: K1 / K4 by route "
        f"{json.dumps(mm_routes)}")
    for tag, by_route in mm_routes.items():
        if by_route["tf32x2"] <= 0 or by_route["tf32x2"] != sum(
                by_route.values()):
            raise AssertionError(f"(f) {tag} not by its tf32x2 route alone: "
                                 f"{by_route}")
    eval_small_rows(rows, cfg)

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_uptrain_",
                            dir=os.path.join(ROOT, "build"))
    try:
        yaml_path = os.path.join(work, "uptrain.yaml")
        with open(yaml_path, "w") as f:
            f.write(FROM_VANILLA_YAML)
        vcfg = config.get_vanilla_config("vanilla_31")
        vdir = os.path.join(work, "vanilla_31")
        vp = vanilla.init_vanilla_params(7, vcfg, device="cpu")
        torch_export._write_component(vdir, torch_export.neox_state_dict(
            vp, vcfg), torch_export._neox_hf_config(vcfg))
        out_dir = os.path.join(work, "out")
        before = launch_counts()
        t = pretrain_block_transformer.main([
            "--config", yaml_path, "--synthetic", "4000", "--steps", "1",
            "--output_dir", out_dir, "--from_vanilla", vdir])
        assert_no_launch(before, "the uptrained step")
        recs = metrics_records(out_dir)
        finite_records(recs, "from_vanilla")
        devices = {p.device.type for p in opt.tree_leaves(t.state.params)}
        if t.state.step != 1 or devices != {torch.device(CARD).type}:
            raise AssertionError(f"from_vanilla: step {t.state.step}, "
                                 f"{devices}")
        log(f"(f) --from_vanilla (vanilla_31 in the HF layout, partition "
            f"into 3 + 3 layers) on the card: step 1 loss "
            f"{recs[-1]['loss']:.5f} [{smi}]")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {"eval small": {"K1": mm_routes["K1"]["tf32x2"],
                           "K3": sum(k3_routes.values()),
                           "K4": mm_routes["K4"]["tf32x2"]}}


def write_byte_corpus(prefix: str) -> None:
    """The fixtures' texts (the wikitext pages first, then the lambada
    passages and the haystack), byte-tokenized, as the indexed corpus at
    ``prefix`` that ``--byte_corpus`` reads."""
    tok = ByteTokenizer()
    texts = ([d["page"] for d in fixture("wikitext_pg", None)]
             + [d["text"] for d in fixture("lambada_pg", None)])
    with open(HAYSTACK) as f:
        texts.append(f.read())
    mmap_dataset.write_mmap_dataset(prefix, [tok.encode(t) for t in texts])


def entry_eval(argv, what: str, smi: str, path: str = "eval entry"):
    """``eval_zero_shot_task.main(argv)`` between a launch-count reset and
    the check of ``path`` ("eval entry", or "eval entry int4" for
    ``--quantize int4``), its W8A8 decisions checked too; the byte tasks'
    metrics finite. Returns (launches, results, decisions, the scoring
    batches)."""
    torch.cuda.synchronize()
    reset_launches()
    with W8A8Decisions() as decisions, ScoringBatches() as batches:
        t0 = time.perf_counter()
        res = eval_zero_shot_task.main(argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    launches = read_launches(path)
    decisions.check(path, launches)
    results = res["results"]
    if sorted(results) != ["pybytes_nextchunk", "pybytes_wikitext"] or not \
            all(math.isfinite(v) for r in results.values()
                for v in r.values()):
        raise AssertionError(f"{path} {what}: {results}")
    log(json.dumps({"eval_entry": what, "path": path, "s": secs,
                    "scored_rows": sum(
        b[0] for b in batches.seen), "metrics": results,
        "K3_by_route": dict(k3.flash_attention.route_launches),
        "K4_by_route": dict(k1.int4_matmul_stacked.route_launches),
        "note": "main() with loading and quantization; "
        "random weights: the metrics prove the path, not the model's "
        "quality", "card": smi}))
    torch.cuda.empty_cache()
    return launches, results, decisions, batches.seen


def phase_eval_entry(rows, cfg, smi) -> dict:
    """(g) The eval entry points as a user calls them, at full width:
    float32 weights as the JAX script loads them, ``--quantize int8``, the
    byte tasks (ENTRY_LIMIT docs each) of a corpus written from the
    fixtures under a temporary directory of ``build/``.
    ``eval_zero_shot_task.main --random``; the same seed-0 float32 tree
    saved as ``checkpoint-1`` and scored through ``--ckpt`` (the train-state
    branch of ``_load_params``); ``export_checkpoint.main`` on that run and
    ``--ckpt`` of the HF tree it writes (the safetensors branch). The three
    results agree within EVAL_F32_TOL. Kernel rows in float32 at the
    longest scoring batch. Returns {path: launches}."""
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_entry_",
                            dir=os.path.join(ROOT, "build"))
    try:
        free = shutil.disk_usage(work).free
        if free < EXPORT_DISK_BYTES:
            raise RuntimeError(f"the entry points need "
                               f"{EXPORT_DISK_BYTES / 1e9:.0f} GB free under "
                               f"{work}; {free / 1e9:.1f} GB are")
        prefix = os.path.join(work, "bytes")
        write_byte_corpus(prefix)
        common = ["--model", MODEL, "--quantize", "int8", "--byte_corpus",
                  prefix, "--limit", str(ENTRY_LIMIT), "--batch_size",
                  str(EVAL_BATCH), "--max_length", str(EVAL_MAX_LENGTH)]
        launches, want, decisions, batches = entry_eval(
            common + ["--random"], "--random", smi)
        int4 = [{"int8": "int4"}.get(a, a) for a in common]
        launches4, *_ = entry_eval(int4 + ["--random"],
                                   "--random --quantize int4", smi,
                                   "eval entry int4")

        params = bt.init_block_transformer_params(0, cfg, dtype=torch.float32,
                                                  device=CARD)
        run, hf = os.path.join(work, "run"), os.path.join(work, "hf")
        t0 = time.perf_counter()
        ckpt.save_checkpoint(run, 1, ts.TrainState(params, None, 1))
        save_s = time.perf_counter() - t0
        del params
        t0 = time.perf_counter()
        export_checkpoint.main(["--model", MODEL, "--run_dir", run, "--out",
                                hf])
        export_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        log(f"(g) {MODEL} float32 seed 0: checkpoint-1 saved in {save_s:.2f}"
            f" s; export_checkpoint.main {export_s:.2f} s [{smi}]")
        for what, src in (("--ckpt checkpoint-1",
                           os.path.join(run, "checkpoint-1")),
                          ("--ckpt HF tree", hf)):
            _, got, *_ = entry_eval(common + ["--ckpt", src], what, smi)
            worst = max(abs(got[t][k] - v) / max(abs(v), 1e-30)
                        for t, r in want.items() for k, v in r.items())
            if sorted(got) != sorted(want) or worst > EVAL_F32_TOL:
                raise AssertionError(f"eval entry {what}: {got} != --random's "
                                     f"{want}")
            log(f"(g) {what}: the --random results within {worst:.3e} "
                f"relative (limit {EVAL_F32_TOL})")
        eval_kernel_rows(rows, cfg, batches, decisions, "eval entry",
                         torch.float32)
        g = torch.Generator(device=CARD).manual_seed(17)
        m_head, m_td = scoring_linear_rows(cfg, batches)
        tcfg = cfg.token_decoder.neox
        k4_f32_row(rows, g, f"float32 scoring lm_head M={m_head}", m_head,
                   tcfg.hidden_size, tcfg.vocab_size, 1, "eval entry int4",
                   5, 2)
        k4_f32_row(rows, g, f"float32 scoring token decoder mlp_up "
                   f"M={m_td}", m_td, tcfg.hidden_size,
                   tcfg.intermediate_size, tcfg.num_layers,
                   "eval entry int4", 10, 3)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {"eval entry": launches, "eval entry int4": launches4}


def phase_eval(rows, smi) -> dict:
    """Evaluation at full width: ``block_main_b4_1.2b``, random bf16 weights
    from a seed, quantized INT8 as ``--quantize int8`` does, the byte
    tokenizer, batch 8, max_length 2048 (d, a, e), ``vanilla_410`` INT8
    (b), the long-context entry point (c), card against CPU and
    ``--from_vanilla`` at small sizes (f), then the zero-shot and export
    entry points in float32 (g). Returns {path: launches}."""
    out = {}
    cfg = config.get_config(MODEL)
    t0 = time.perf_counter()
    params = bt.init_block_transformer_params(0, cfg, dtype=torch.bfloat16,
                                              device=CARD)
    phase_eval_export(cfg, params, smi)
    q8 = quant.quantize_block_transformer(params, bits=8)
    del params
    torch.cuda.synchronize()
    log(f"eval: {MODEL} random init + export + int8 quantization "
        f"{time.perf_counter() - t0:.2f} s")

    # (a) the fixture suite through the harness
    tok = ByteTokenizer()
    lm = CountingBlockLM(q8, cfg, tok, max_length=EVAL_MAX_LENGTH,
                         batch_size=EVAL_BATCH)
    score = [eval_tasks.LambadaOpenAI(docs=fixture("lambada_pg", 64)),
             eval_tasks.Wikitext(docs=fixture("wikitext_pg", 4))]
    trivia = fixture("trivia_real", 30)
    generate = [eval_tasks.TriviaQA(docs=trivia[:8]),
                FewshotTriviaQA(trivia[:8], trivia[8:]),
                eval_tasks.GSM8K(docs=fixture("gsm8k_style", 2))]
    torch.cuda.reset_peak_memory_stats()
    with ScoringBatches() as batches:
        out["eval score"], _, decisions = eval_path(lm, score, "eval score",
                                                    smi)
    log(f"eval score: peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    out["eval generate"], _, _ = eval_path(lm, generate, "eval generate",
                                           smi)
    eval_kernel_rows(rows, cfg, batches.seen, decisions)

    # (e) the two-level decode's stages, one at a time
    d = profiling.decompose_generation(q8, cfg, batch=EVAL_BATCH,
                                       n_blocks=32, n_rep=3)
    m = roofline.mfu_summary(cfg, batch=EVAL_BATCH, prefill=cfg.block_length,
                             decode=0, kv_cache="bf16", quantize="int8",
                             bd_ms=d["block_decoder_s"] * 1e3,
                             td_ms=d["token_decoder_s"] * 1e3)
    log(json.dumps({"decompose_generation": d, "batch": EVAL_BATCH,
                    "weights": "int8", "mfu_summary": m,
                    "peaks": [roofline.PEAK_BF16_FLOPS,
                              roofline.PEAK_HBM_GBPS], "card": smi}))
    del lm, q8
    torch.cuda.empty_cache()

    # (b) the baseline's adapter on the same lambada docs
    vcfg, vparams = pg.vanilla_model(seed=0, quantize="int8")
    vlm = CountingVanillaLM(vparams, vcfg, tok, max_length=EVAL_MAX_LENGTH,
                            batch_size=EVAL_BATCH)
    out["eval vanilla"], _, _ = eval_path(
        vlm, [eval_tasks.LambadaOpenAI(docs=fixture("lambada_pg", 64))],
        "eval vanilla", smi)
    del vlm, vparams
    torch.cuda.empty_cache()

    out.update(phase_eval_longctx(smi))
    out.update(phase_eval_small(rows, smi))
    out.update(phase_eval_entry(rows, cfg, smi))
    return out


# ---------------------------------------------------------------------------
# phase_quality: the quantization-quality scripts on trained weights
# ---------------------------------------------------------------------------

# the quality phase's cuts of the scripts' defaults, for time
QUALITY_CORPUS_MB = 20        # build_byte_corpus --max_mb (default 200)
QUALITY_STEPS = 150           # quality_run --steps (default 3000)
QUALITY_EVAL_SAMPLES = 64     # --eval_samples (default 256)
QUALITY_CALIB = 32            # quality_run / gptq_gate --calib_samples
QUALITY_QAT_STEPS = 50        # qat_finetune --steps (default 1000)
QUALITY_LIMIT = 8             # real_task_eval --limit (default: every doc)
QUALITY_GPTQ_CONFIGS = "gptq_int4_g128,gptq_mixed48"
QUALITY_PPL_RATIO = 0.1       # trained fp32 ppl / untrained, at most
QUALITY_CARD_CPU_RTOL = 1e-4  # held-out ppl and the decode gate's
                              # reference logprob, card against the CPU
QUALITY_CARD_CPU_SAMPLES = 16
QUALITY_W8A8_RTOL = 0.01      # INT8 ppl with W8A8 against fp32
# the kernels the phase must launch; every activation is float32: K1 and K4
# by their TF32 route, K3 by its CUDA-core route (head dim 32)
PATH_KERNELS["quality"] = ("K1", "K2", "K2 bf16", "K3", "K4", *K5_FUSED,
                           *W8A8)
PATH_ABSENT["quality"] = ("K6", "K6 int4", *K7_FUSED, "K8", "K8 int4")
PATH_ROUTES["quality"] = {"K1": "tf32x2", "K3": "fma", "K4": "tf32x2"}
K2_SPLIT_PATHS += ("quality",)


def quality_ppl_card_vs_cpu(cfg, block_dir, ds) -> dict:
    """The trained block model's held-out ppl on QUALITY_CARD_CPU_SAMPLES
    samples, card against CPU (plain versions): fp32 (K3's CUDA-core
    route, float32 matmuls), INT8 under ``w8a8_disabled()`` (K1 by its TF32
    route) and INT4 g128 (K4 by its TF32 route); each within
    QUALITY_CARD_CPU_RTOL relative. Returns {name: (card, cpu)}."""
    step = ckpt.find_latest_checkpoint(block_dir)
    out = {}
    trees = {dev: ckpt.restore_params(block_dir, step, device=dev)
             for dev in (CARD, "cpu")}
    for name, kw in (("fp32", None), ("int8", dict(bits=8)),
                     ("int4 g128", dict(bits=4, group_size=128))):
        got = []
        for dev in (CARD, "cpu"):
            tree = trees[dev] if kw is None else \
                quant.quantize_block_transformer(trees[dev], **kw)
            with linear_ops.w8a8_disabled():
                got.append(quality_run.heldout_ppl_block(
                    tree, cfg, ds, QUALITY_CARD_CPU_SAMPLES,
                    QUALITY_CARD_CPU_SAMPLES))
        rel = abs(got[0] - got[1]) / got[1]
        log(f"quality: held-out ppl {name} on the card {got[0]:.6f}, on the "
            f"CPU {got[1]:.6f}: {rel:.3e} relative (limit "
            f"{QUALITY_CARD_CPU_RTOL})")
        if not rel <= QUALITY_CARD_CPU_RTOL:
            raise AssertionError(f"quality: {name} ppl card {got[0]} / CPU "
                                 f"{got[1]}")
        out[name] = got
    return out


def quality_gate_rescore(cfg, block_dir, holdout, report) -> float:
    """The decode gate's reference decode (fp32 weights, bf16 KV, W8A8 off)
    again on the card, scored on the card (the report's reference again)
    and rescored on the CPU over the card's tokens, each within
    QUALITY_CARD_CPU_RTOL. Returns the CPU's logprob."""
    step = ckpt.find_latest_checkpoint(block_dir)
    prompts = decode_gate.sample_prompts(holdout, report["batch"],
                                         report["prompt_len"],
                                         report["prompt_seed"])
    n = report["gen_tokens"]
    params = ckpt.restore_params(block_dir, step, device=CARD)
    toks = decode_gate.run_variant(params, cfg, prompts, "bf16", n)
    card = decode_gate.fp32_scorer(params, cfg, prompts, n)(toks)
    del params
    cpu = decode_gate.fp32_scorer(ckpt.restore_params(
        block_dir, step, device="cpu"), cfg, prompts, n)(toks)
    ref = report["fp32_mean_logprob_ref"]
    log(f"quality: decode gate reference logprob {ref:.7f}; the card's "
        f"decode again, scored on the card {card:.7f}, rescored on the CPU "
        f"{cpu:.7f} ({abs(cpu - card) / abs(card):.3e} relative, limit "
        f"{QUALITY_CARD_CPU_RTOL})")
    if abs(card - ref) > QUALITY_CARD_CPU_RTOL * abs(ref) or \
            abs(cpu - card) > QUALITY_CARD_CPU_RTOL * abs(card):
        raise AssertionError(f"quality: decode gate reference {ref}, card "
                             f"again {card}, CPU {cpu}")
    return cpu


def quality_kernel_rows(rows, cfg, vcfg) -> None:
    """Kernel rows at the quality path's shapes (``block_main_b4_5``: hidden
    256, 8 heads of 32; all float32): K3 by its CUDA-core route at the
    held-out scoring of the baseline (B = 16, Q = K = 1024, causal) and of
    the block decoder (B = 16, 256 blocks, block-causal); the decode gate's
    step at B = 384: K1 and K4 (g128) by their TF32 route at the block
    decoder's qkv (M = 384, K = 256, N = 768), W8A8-q / -mm there, K2 over
    its INT8 and its float32 global cache (80 slots), and K5 fused at its
    write."""
    g = torch.Generator(device=CARD).manual_seed(20)
    bcfg, path = cfg.block_decoder, "quality"
    B, H, D = QUALITY_EVAL_BATCH, vcfg.num_heads, vcfg.head_dim
    S = vcfg.max_position_embeddings
    qkv = [tuple(torch.randn((B, H, S, D), generator=g, device=CARD)
                 for _ in range(3)) for _ in range(2)]
    mask = masks.decode_mask(0, S, S, torch.ones((B, S), dtype=torch.int32,
                                                 device=CARD), device=CARD)
    k3_row(rows, f"float32 baseline scoring B={B} H={H} Q=K={S} D={D} "
           f"causal", qkv, mask, 10, 3, path=path, route="fma",
           peak=TF32X3_FLOPS, tol=K3_F32_TOL)
    N = S // cfg.block_length
    qkv = [tuple(torch.randn((B, H, N, D), generator=g, device=CARD)
                 for _ in range(3)) for _ in range(3)]
    mask = masks.block_decoder_train_mask(
        torch.ones((B, N), dtype=torch.int32, device=CARD),
        cfg.n_embedding_tokens)
    k3_row(rows, f"float32 block decoder scoring B={B} H={H} Q=K={N} "
           f"D={D} block-causal", qkv, mask, 20, 5, path=path, route="fma",
           peak=TF32X3_FLOPS, tol=K3_F32_TOL)
    del qkv
    M, h, L = QUALITY_GATE_BATCH, bcfg.hidden_size, bcfg.num_layers
    k1_row(rows, g, f"float32 decode gate qkv M={M} K={h} N={3 * h}", M, h,
           3 * h, L, path=path, dtype=torch.float32)
    k4_f32_row(rows, g, f"float32 decode gate qkv M={M} K={h} N={3 * h}",
               M, h, 3 * h, L, path, 50, 10, group=128)
    w8a8_rows(rows, g, "float32 decode gate qkv", M, h, 3 * h, L, path,
              dtype=torch.float32)
    cap = QUALITY_GATE_CAP
    Hb, Db = bcfg.num_heads, bcfg.head_dim
    valid = torch.ones((M, cap), dtype=torch.int32, device=CARD)
    valid[:, cap - 8:] = 0                       # blocks not decoded yet
    mask = masks.block_decode_mask(cap - 9, cap, 1, valid)
    q = torch.randn((M, Hb, 1, Db), generator=g, device=CARD)
    k2_row(rows, f"float32 decode gate B={M} H={Hb} S=1 D={Db} cap={cap}",
           int8_layers(g, L, M, Hb, cap, Db), q, mask, 50, path=path,
           tol=K3_F32_TOL)
    kv = tuple(torch.randn((L, M, Hb, cap, Db), generator=g, device=CARD)
               for _ in range(2))
    k2_row(rows, f"float32 cache, decode gate B={M} H={Hb} S=1 D={Db} "
           f"cap={cap}", kv, q, mask, 50, path=path, tol=K3_F32_TOL)
    del kv
    k5_fused_row(rows, g, path, L, M, Hb, Db, cap, cap - 9,
                 dtype=torch.float32)


KV_PROBE_SCHEMES = "bf16,sym8,sym4,k8v4"   # kv_scheme_probe --schemes
                                           # (default: all eight)
PATH_KERNELS["script kv_scheme_probe"] = ("K2 bf16", "K3")
PATH_ABSENT["script kv_scheme_probe"] = ("K1", "K2", "K4", *W8A8, *SERVING)
PATH_ROUTES["script kv_scheme_probe"] = {"K3": "fma"}
K2_SPLIT_PATHS += ("script kv_scheme_probe",)


def quality_kv_scheme_probe(block_dir, holdout, work, smi) -> dict:
    """``kv_scheme_probe`` on the phase's trained checkpoint (float32,
    heads of 32: K3 by its CUDA-core route; the bf16 global cache, 76
    blocks, by K2 bf16's split route, the local cache by its warp route),
    its own launch window; raises unless the reference and every scheme
    scored a finite logprob and some scheme moved it."""
    log(f"kv_scheme_probe: cut for time: --schemes {KV_PROBE_SCHEMES} "
        f"(default: all eight)")
    torch.cuda.synchronize()
    reset_launches()
    report = kv_scheme_probe.main([
        "--model_dir", block_dir, "--corpus", holdout, "--schemes",
        KV_PROBE_SCHEMES, "--out", os.path.join(work, "kv_scheme.json")])
    torch.cuda.synchronize()
    read_launches("script kv_scheme_probe")
    log(json.dumps({"kv_scheme_probe": report, "card": smi}))
    lps = [report["fp32_mean_logprob_ref"]] + [
        v["fp32_mean_logprob"] for v in report["schemes"].values()]
    if not all(math.isfinite(x) for x in lps) or sorted(
            report["schemes"]) != sorted(KV_PROBE_SCHEMES.split(",")[1:]):
        raise AssertionError(f"kv_scheme_probe: {report}")
    if all(x == report["fp32_mean_logprob_ref"] for x in lps[1:]):
        raise AssertionError("kv_scheme_probe: every scheme decoded as bf16 "
                             "did: the layer_qkv patch reached nothing")
    return report


QUALITY_EVAL_BATCH = 16       # quality_run --eval_batch
QUALITY_GATE_BATCH = 384      # decode_gate --batch
QUALITY_GATE_CAP = 80         # its global cache: 64 prompt + 16 new blocks


def phase_quality(rows, smi) -> dict:
    """The port's quantization-quality scripts through their ``main(argv)``
    at full width (``block_main_b4_5``, byte vocab, max length 1024) under
    a temporary directory of ``build/``, with the launch counts set to 0
    just before the first script and read (the ``quality`` path: every
    kernel of it launched) just after the last: (a) ``build_byte_corpus``
    over this Python's stdlib; (b) ``quality_run --gptq`` (trains the
    block model and the ``vanilla_31`` baseline, then every phase); (c)
    ``decode_gate --w8a8 --gptq`` at its defaults (batch 384, prompt 256,
    64 new tokens: decode M reaches the W8A8 window); (d) ``qat_finetune
    --recipe mixed48 --distill`` and ``qat_ppl_gate``; (e) ``gptq_gate``
    with two configurations; (f) ``kv_quality_cpu``,
    ``longctx_quality_cpu`` and ``real_task_eval``; the corpus, steps and
    samples cut for time (each cut logged). Then, outside that window,
    raises unless the trained fp32 ppl is at most QUALITY_PPL_RATIO of the
    untrained parameters', the card's ppl matches the CPU's (fp32, INT8
    under ``w8a8_disabled``, INT4 g128), the INT8 ppl with W8A8 is within
    QUALITY_W8A8_RTOL of fp32 and the decode gate's reference rescored on
    the CPU matches, then runs ``kv_scheme_probe`` on the trained
    checkpoint in a launch window of its own
    (``quality_kv_scheme_probe``), and ``w8a8_decode_gate`` in one more
    (``quality_w8a8_decode_gate``). Then kernel rows at its shapes
    (``quality_kernel_rows``).
    Returns {"quality": launches}."""
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_quality_",
                            dir=os.path.join(ROOT, "build"))
    log(f"quality: cuts for time: build_byte_corpus --max_mb "
        f"{QUALITY_CORPUS_MB} (default 200); quality_run --steps "
        f"{QUALITY_STEPS} (default 3000), --eval_samples "
        f"{QUALITY_EVAL_SAMPLES} (default 256), --calib_samples "
        f"{QUALITY_CALIB} (default 256); qat_finetune --steps "
        f"{QUALITY_QAT_STEPS} (default 1000); qat_ppl_gate and gptq_gate "
        f"--eval_samples {QUALITY_EVAL_SAMPLES} (default 256); gptq_gate "
        f"--calib_samples {QUALITY_CALIB} (default 64), --configs "
        f"{QUALITY_GPTQ_CONFIGS} (default: all five); real_task_eval --limit "
        f"{QUALITY_LIMIT} (default: every doc); the decode gate at its "
        f"defaults")
    secs = {}

    def step(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        log(f"quality: {name} {secs[name]:.1f} s")
        return out

    try:
        prefix = os.path.join(work, "corpus", "pybytes")
        out = os.path.join(work, "quality")
        block_dir = os.path.join(out, "block_main_b4_5")
        gate_out = os.path.join(work, "decode_gate.json")
        qat_dir = os.path.join(work, "qat")
        torch.cuda.synchronize()
        started = time.perf_counter()
        # the launch window holds the scripts' main() calls and nothing
        # else; the phase's own checks run after the counts are read
        reset_launches()
        corpus = step("build_byte_corpus", lambda: build_byte_corpus.main(
            ["--out", prefix, "--max_mb", str(QUALITY_CORPUS_MB)]))
        report = step("quality_run", lambda: quality_run.main([
            "--corpus", prefix, "--out", out, "--steps", str(QUALITY_STEPS),
            "--eval_samples", str(QUALITY_EVAL_SAMPLES), "--calib_samples",
            str(QUALITY_CALIB), "--gptq"]))
        gate = step("decode_gate", lambda: decode_gate.main([
            "--model_dir", block_dir, "--corpus", prefix + "_holdout",
            "--train_corpus", prefix, "--w8a8", "--gptq", "--out",
            gate_out]))
        qat = step("qat_finetune", lambda: qat_finetune.main([
            "--model_dir", block_dir, "--corpus", prefix, "--recipe",
            "mixed48", "--distill", "--steps", str(QUALITY_QAT_STEPS),
            "--out_dir", qat_dir]))
        qat_ppl = step("qat_ppl_gate", lambda: qat_ppl_gate.main([
            "--qat_dir", qat_dir, "--baseline_dir", block_dir, "--corpus",
            prefix, "--eval_samples", str(QUALITY_EVAL_SAMPLES), "--out",
            os.path.join(work, "qat_ppl.json")]))
        gq = step("gptq_gate", lambda: gptq_gate.main([
            "--model_dir", block_dir, "--corpus", prefix, "--out",
            os.path.join(work, "gptq_gate.json"), "--configs",
            QUALITY_GPTQ_CONFIGS, "--eval_samples",
            str(QUALITY_EVAL_SAMPLES), "--calib_samples",
            str(QUALITY_CALIB)]))
        kvq = step("kv_quality_cpu", lambda: kv_quality_cpu.main([
            "--out", out, "--corpus", prefix]))
        lc = step("longctx_quality_cpu", lambda: longctx_quality_cpu.main([
            "--out", out, "--corpus", prefix]))
        rt = step("real_task_eval", lambda: real_task_eval.main([
            "--model_dir", block_dir, "--out", os.path.join(work, "real"),
            "--limit", str(QUALITY_LIMIT)]))
        torch.cuda.synchronize()
        scripts_s = time.perf_counter() - started
        launches = read_launches("quality")
        log("quality launches " + json.dumps({
            "K1": launches["K1"], "K4": launches["K4"],
            "W8A8-q": launches["W8A8-q"], "W8A8-mm": launches["W8A8-mm"],
            "K2 by form": {"int8": launches["K2"],
                           "bf16 warp": launches["K2 bf16 warp"],
                           "bf16 split": launches["K2 bf16 split"]},
            "K3 by route": dict(k3.flash_attention.route_launches),
            "K5 fused": launches["K5 fused"]}))

        cfg = config.get_config("block_main_b4_5",
                                vocab_size=quality_run.VOCAB,
                                max_length=1024)
        vcfg = config.get_vanilla_config(
            "vanilla_31", vocab_size=quality_run.VOCAB,
            max_position_embeddings=1024)
        ds = quality_run.make_dataset(quality_run.load_corpus(
            prefix + "_holdout"), 1024, cfg.block_length, seed=7)
        # the trainer's initial parameters (its seed, 42) on the same slice
        untrained = step("untrained ppl", lambda: quality_run.
                         heldout_ppl_block(bt.init_block_transformer_params(
                             42, cfg, dtype=torch.float32, device=CARD),
                             cfg, ds, QUALITY_EVAL_SAMPLES,
                             QUALITY_EVAL_BATCH))
        p = report["ppl"]
        log(json.dumps({"quality_corpus": corpus}))
        log(json.dumps({"quality_run": {"ppl": p, "untrained_fp32_ppl":
                                        untrained,
                                        "decode_agreement":
                                        report["decode_agreement"],
                                        "harness": report["harness"]},
                        "card": smi}))
        log(json.dumps({"decode_gate": {
            "fp32_mean_logprob_ref": gate["fp32_mean_logprob_ref"],
            "variants": {n: {k: v[k] for k in (
                "fp32_logprob_delta_pct", "gate", "greedy_agreement")}
                for n, v in gate["variants"].items()}}, "card": smi}))
        log(json.dumps({"qat": {k: qat[k] for k in (
            "recipe", "distill", "steps", "train_s", "losses_per_100")},
            "qat_ppl_gate": qat_ppl}))
        log(json.dumps({"gptq_gate": gq}))
        log(json.dumps({"kv_quality": kvq, "longctx": {
            k: v for k, v in lc.items() if not k.endswith("every_64")},
            "real_tasks": rt["gates_vs_fp32"]}))
        ratio = p["block_fp32"] / untrained
        log(f"quality: trained fp32 ppl {p['block_fp32']:.4f}, untrained "
            f"{untrained:.4f}: ratio {ratio:.4f} (limit "
            f"{QUALITY_PPL_RATIO}); INT8 with W8A8 {p['int8_delta_pct']:+.4f}"
            f"% (limit {100 * QUALITY_W8A8_RTOL}%)")
        if not ratio <= QUALITY_PPL_RATIO:
            raise AssertionError(f"quality: trained ppl {p['block_fp32']} "
                                 f"not below {QUALITY_PPL_RATIO} x "
                                 f"{untrained}")
        if not abs(p["int8_delta_pct"]) <= 100 * QUALITY_W8A8_RTOL:
            raise AssertionError(f"quality: INT8 (W8A8) ppl "
                                 f"{p['block_int8']} against fp32 "
                                 f"{p['block_fp32']}")
        step("card vs CPU ppl", lambda: quality_ppl_card_vs_cpu(
            cfg, block_dir, ds))
        step("kv_scheme_probe", lambda: quality_kv_scheme_probe(
            block_dir, prefix + "_holdout", work, smi))
        step("w8a8_decode_gate", lambda: quality_w8a8_decode_gate(
            block_dir, prefix + "_holdout", work, smi))
        step("decode gate rescored on the CPU", lambda: quality_gate_rescore(
            cfg, block_dir, prefix + "_holdout", gate))
        torch.cuda.synchronize()
        phase_s = time.perf_counter() - started
        log(json.dumps({"quality_phase_s": phase_s, "scripts_s": scripts_s,
                        "steps_s": secs, "card": smi}))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    quality_kernel_rows(rows, cfg, vcfg)
    return {"quality": launches}


# ---------------------------------------------------------------------------
# phase_scripts: the entry scripts and the packer benchmark
# (block_transformer_tpu_torch/scripts/)
# ---------------------------------------------------------------------------

SCRIPTS_DEMO = ["--batch", "32", "--prompt_len", "512", "--max_length", "640"]
SCRIPTS_BATCH = 8             # measure_generation_time --batch (default auto)
SCRIPTS_PREFILL = 128         # its --prefill (default 1)
SCRIPTS_DECODE = 64           # its --decode (default 2048)
SCRIPTS_REPS = 2              # its --n_rep (default 5)
SCRIPTS_MFU = ["--batch", "2", "--max_length", "2048", "--vocab", "50304",
               "--warmup", "1", "--steps", "2", "--corpus", ""]
SCRIPTS_CORPUS_MB = 2         # build_byte_corpus --max_mb (default 200),
SCRIPTS_HOLDOUT_EVERY = 5     # --holdout_every (default 100): the holdout
                              # must hold two contexts of 8192
SCRIPTS_CKPT_STEPS = 4        # train_ckpt --steps (default 5000)
SCRIPTS_CKPTS = 2             # its --n_checkpoints (default 5)
SCRIPTS_LONGCTX = ["--context", "8192", "--max_docs", "2", "--depths",
                   "0,50,100"]    # defaults: 16 docs, 11 depths
SCRIPTS_PACKER_DOCS = 20000   # bench_packer --n_docs (default 200000)
# bf16 weights (no K1, K4 or W8A8) and the bf16 global cache (over 32
# blocks: K2 bf16's split route; the local cache: its warp route); K3 on
# the tensor cores (heads of 128 or 64)
for _path in ("script inference_demo", "script measure_generation_time",
              "script measure_generation_time auto", "script longctx_85m",
              "script measure_generation_time vanilla"):
    PATH_KERNELS[_path] = ("K2 bf16", "K3")
    PATH_ABSENT[_path] = ("K1", "K2", "K4", *W8A8, *SERVING)
    K2_SPLIT_PATHS += (_path,)
K2_NO_LOCAL_CACHE += ("script measure_generation_time vanilla",)


def script_step(secs: dict, name: str, fn, argv, path=None):
    """``fn(argv)`` (a script's ``main``) between device synchronizations,
    its seconds into ``secs[name]``: with ``path``, in a launch window of
    its own read as ``path`` (every kernel of it launched, none it must
    not); without, no kernel may launch (training: autograd). Returns
    (report, launches or None)."""
    torch.cuda.synchronize()
    reset_launches()
    before = launch_counts()
    t0 = time.perf_counter()
    report = fn([str(a) for a in argv])
    torch.cuda.synchronize()
    secs[name] = time.perf_counter() - t0
    log(f"scripts: {name} {secs[name]:.1f} s")
    if path is None:
        assert_no_launch(before, name)
        return report, None
    return report, read_launches(path)


def finite(what: str, *xs) -> None:
    if not all(math.isfinite(float(x)) for x in xs):
        raise AssertionError(f"{what}: not finite: {xs}")


def phase_scripts(smi) -> dict:
    """The entry scripts through their ``main(argv)`` on the card under a
    temporary directory of ``build/``, each in a launch window of its own
    (K2 bf16 and K3 by route logged and asserted): ``inference_demo`` at
    ``block_main_b4_1.2b`` (bf16, B = 32, p512 to 640); ``measure_
    generation_time`` at ``block_main_b4_1.2b`` and ``vanilla_410`` at a
    fixed batch, then at ``block_main_b4_1.2b`` with ``--batch auto``
    (peak memory at most ``hbm_bytes_limit()``); ``train_mfu`` at
    ``block_main_b4_1.2b`` (float32, B = 2 x 2048, no kernel under
    autograd); ``train_ckpt`` at ``block_main_b4_85`` on a small
    ``build_byte_corpus`` corpus; ``longctx_85m`` on that checkpoint at a
    context of 8192 (2 docs, 3 depths); ``bench_packer`` at a cut corpus.
    Raises on any failure: non-finite figures, tokens out of the vocab, a
    missing checkpoint, packers that disagree. Returns {path: launches}."""
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_scripts_",
                            dir=os.path.join(ROOT, "build"))
    log(f"scripts: cuts for time: inference_demo {' '.join(SCRIPTS_DEMO)}; "
        f"measure_generation_time --batch {SCRIPTS_BATCH} and auto (default "
        f"auto), --prefill {SCRIPTS_PREFILL} (default 1), --decode "
        f"{SCRIPTS_DECODE} (default 2048), --n_rep {SCRIPTS_REPS} (default "
        f"5); train_mfu {' '.join(SCRIPTS_MFU[:-2])} (defaults: batch 16, "
        f"1024 tokens, vocab 512, 3 + 30 steps), synthetic batches; "
        f"build_byte_corpus --max_mb {SCRIPTS_CORPUS_MB} (default 200), "
        f"--holdout_every {SCRIPTS_HOLDOUT_EVERY} (default 100); "
        f"train_ckpt --steps {SCRIPTS_CKPT_STEPS} (default 5000), "
        f"--n_checkpoints {SCRIPTS_CKPTS} (default 5); longctx_85m "
        f"{' '.join(SCRIPTS_LONGCTX)} (defaults 16 docs, 11 depths), no "
        f"vanilla pairing; bench_packer --n_docs {SCRIPTS_PACKER_DOCS} "
        f"(default 200000)")
    secs, launches = {}, {}
    started = time.perf_counter()
    try:
        demo, launches["script inference_demo"] = script_step(
            secs, "inference_demo", inference_demo.main,
            ["--model", MODEL, *SCRIPTS_DEMO], "script inference_demo")
        toks = demo["tokens"]
        if toks.shape != (32, 640) or toks.min() < 0 or \
                toks.max() >= config.get_config(MODEL).vocab_size:
            raise AssertionError(f"inference_demo tokens {toks.shape} "
                                 f"[{toks.min()}, {toks.max()}]")
        finite("inference_demo", demo["tokens_per_sec"])
        log(json.dumps({"inference_demo": {
            k: v for k, v in demo.items() if k != "tokens"}, "card": smi}))

        rows = []
        for name, model, batch, path in (
                ("measure_generation_time", MODEL, SCRIPTS_BATCH,
                 "script measure_generation_time"),
                ("measure_generation_time vanilla", VANILLA_MODEL,
                 SCRIPTS_BATCH, "script measure_generation_time vanilla"),
                ("measure_generation_time auto", MODEL, "auto",
                 "script measure_generation_time auto")):
            torch.cuda.reset_peak_memory_stats()
            row, launches[path] = script_step(
                secs, name, measure_generation_time.main, [
                    "--model", model, "--batch", batch, "--prefill",
                    SCRIPTS_PREFILL, "--decode", SCRIPTS_DECODE, "--n_rep",
                    SCRIPTS_REPS, "--out", os.path.join(work, "gen")], path)
            peak = torch.cuda.max_memory_allocated()
            finite(name, row["mean_ms"], row["tokens_per_sec"])
            rows.append({**row, "peak_bytes": peak})
        limit = hbm.hbm_bytes_limit()
        log(f"scripts: --batch auto chose batch {rows[-1]['batch']} at "
            f"p{SCRIPTS_PREFILL}/d{SCRIPTS_DECODE}; peak "
            f"{rows[-1]['peak_bytes'] / 2**30:.2f} GiB of "
            f"hbm_bytes_limit() {limit / 2**30:.2f} GiB")
        if not rows[-1]["peak_bytes"] <= limit:
            raise AssertionError(f"--batch auto: peak {rows[-1]['peak_bytes']}"
                                 f" over the card's {limit} bytes")
        log(json.dumps({"measure_generation_time": rows, "card": smi}))

        mfu, _ = script_step(secs, "train_mfu", train_mfu.main,
                             ["--model", MODEL, *SCRIPTS_MFU])
        finite("train_mfu", mfu["loss_first"], mfu["loss_last"],
               mfu["train_mfu_best"])
        log(json.dumps({"train_mfu": mfu, "card": smi}))

        prefix = os.path.join(work, "corpus", "pybytes")
        corpus, _ = script_step(secs, "build_byte_corpus",
                                build_byte_corpus.main,
                                ["--out", prefix, "--max_mb",
                                 SCRIPTS_CORPUS_MB, "--holdout_every",
                                 SCRIPTS_HOLDOUT_EVERY])
        run, _ = script_step(secs, "train_ckpt", train_ckpt.main, [
            "--model", "block_main_b4_85", "--corpus", prefix, "--out",
            os.path.join(work, "scale85"), "--steps", SCRIPTS_CKPT_STEPS,
            "--n_checkpoints", SCRIPTS_CKPTS])
        recs = metrics_records(run["out"])
        finite_records(recs, "train_ckpt")
        every = SCRIPTS_CKPT_STEPS // SCRIPTS_CKPTS
        if run["checkpoint_steps"] != list(range(
                every, SCRIPTS_CKPT_STEPS + 1, every)):
            raise AssertionError(f"train_ckpt checkpoints "
                                 f"{run['checkpoint_steps']}")
        log(json.dumps({"build_byte_corpus": corpus, "train_ckpt": {
            **run, "records": [{k: r[k] for k in (
                "step", "loss", "grad_norm", "wall_time_s")} for r in recs]},
            "card": smi}))

        lc, launches["script longctx_85m"] = script_step(
            secs, "longctx_85m", longctx_85m.main, [
                "--model", "block_main_b4_85", "--model_dir", run["out"],
                "--corpus", prefix + "_holdout", *SCRIPTS_LONGCTX,
                "--haystack", HAYSTACK, "--out",
                os.path.join(work, "longctx_85m.json")],
            "script longctx_85m")
        finite("longctx_85m", *lc["block_pos_loss_every_256"],
               lc["block_loss_beyond_1024_mean"])
        if lc["n_chunks"] < 1 or lc["needle_samples"] != 6:
            raise AssertionError(f"longctx_85m: {lc}")
        log(json.dumps({"longctx_85m": lc, "card": smi}))

        packer, _ = script_step(secs, "bench_packer", bench_packer.main,
                                ["--n_docs", SCRIPTS_PACKER_DOCS])
        if not packer.get("equal"):
            raise AssertionError(f"bench_packer: the routes differ or the "
                                 f"native one did not build: {packer}")
        log(json.dumps({"bench_packer": packer, "card": smi}))
    finally:
        shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()
    log(json.dumps({"scripts_phase_s": time.perf_counter() - started,
                    "steps_s": secs, "card": smi}))
    return launches


# ---------------------------------------------------------------------------
# phase_probes: the ten speed probes (block_transformer_tpu_torch/scripts/)
# ---------------------------------------------------------------------------

# the probes' cuts for time (their defaults in the logged line)
PROBE_MICROBENCH = ["--iters", "16"]          # default 32
PROBE_PREFILL = ["--batch", "64"]             # default 256
PROBE_ADMIT = ["--reps", "1", "--decode", "16"]   # defaults 3, 64
PROBE_MIXED48_ITERS = 4       # bench.ITERS in mixed48_stage_probe (32)
PROBE_RATIO = ["--reps", "2"]                 # default 3
W8A8_GATE_BATCH = 384                         # w8a8_decode_gate --batch
# the kernels each probe's run must launch, and those it must not
_NOT_W8A8 = ("K2", "K2 bf16", "K3", "K4", *SERVING)
for _path, _must, _absent in (
        ("probe w8a8_probe", ("K1", *W8A8), _NOT_W8A8),
        ("probe w8a8_probe2", W8A8, ("K1", *_NOT_W8A8)),
        ("probe w8a8_probe3", ("K1", *W8A8), _NOT_W8A8),
        # the INT4 cache's step attends on the plain path (one query row)
        ("probe int4kv_probe", ("K2", "K2 bf16", *K5_FUSED),
         ("K1", "K3", "K4", *W8A8, "K6", "K6 int4", *K7_FUSED, "K8",
          "K8 int4")),
        ("probe kernel_microbench", ("K1", "K2", "K3", "K4"),
         ("K2 bf16", *W8A8, *SERVING)),
        # prompt-shaped writes (S > 8) are not fused; no decode step
        ("probe prefill_profile", ("K3", *W8A8),
         ("K2", "K2 bf16", "K4", *SERVING)),
        ("probe mixed48_stage_probe", ("K1", "K2 bf16", "K3", "K4", *W8A8),
         ("K2", *SERVING)),
        ("probe paged_admit_probe", ("K1", "K2", "K2 bf16", "K3", *K5_FUSED,
                                     "K6", *K7_FUSED, "K8", *W8A8),
         ("K4", "K6 int4", "K8 int4")),
        # bf16 weights (no K1, K4, W8A8); heads of 32: K3 by its fma route
        ("probe engine_cpu_ratio", ("K2", "K2 bf16", "K3", *K5_FUSED),
         ("K1", "K4", *W8A8, "K6", "K6 int4", *K7_FUSED, "K8", "K8 int4")),
        # the trained float32 block_main_b4_5: K1 by tf32x2, K3 by fma
        ("probe w8a8_decode_gate", ("K1", "K2", "K2 bf16", "K3", *K5_FUSED,
                                    *W8A8),
         ("K4", "K6", "K6 int4", *K7_FUSED, "K8", "K8 int4"))):
    PATH_KERNELS[_path], PATH_ABSENT[_path] = _must, _absent
K2_NO_LOCAL_CACHE += ("probe int4kv_probe",)
K2_SPLIT_PATHS += ("probe int4kv_probe",)
PATH_ROUTES["probe engine_cpu_ratio"] = {"K3": "fma"}
PATH_ROUTES["probe w8a8_decode_gate"] = {"K1": "tf32x2", "K3": "fma"}
probe_secs = {}                 # every probe's main() seconds
probe_launches = {}             # its launches by kernel


def probe_pair(what: str, got, want, exact_: bool = False) -> float:
    """A probe's kernel output against its plain version at the probe's
    shape: bit for bit (``exact_``), else within TOL of max|plain| (bf16).
    Logs and returns the error."""
    if exact_:
        exact_pair(what, got if isinstance(got, (tuple, list)) else (got,),
                   want if isinstance(want, (tuple, list)) else (want,))
        err, note = 0.0, "bit for bit"
    else:
        err, pmax = compare(what, got, want)
        note = f"max|plain| {pmax:.3e}"
    log(f"probes: {what}: max |kernel - plain| {err:.3e} ({note})")
    return err


def probe_checks_w8a8():
    """W8A8-q / W8A8-mm bit for bit and K1 within TOL at the three W8A8
    probes' shapes; ``int8_pure_body``'s shift against the exact int32
    sum: equal where |sum| < 2^24, one apart at most above it."""
    x, _, w_q, s = w8a8_probe.inputs(CARD)
    probe_pair("w8a8_probe K1 M=32768 K=2048 N=8192",
               w8a8_probe.convert_body(x, w_q, s),
               k1.int8_matmul_stacked_plain(x, w_q[None], s[None], 0))
    probe_pair("w8a8_probe W8A8-q", w8a8.w8a8_quant(x),
               w8a8.w8a8_quant_plain(x), True)
    xq, sx = w8a8.w8a8_quant_plain(x)
    probe_pair("w8a8_probe W8A8-mm",
               w8a8.w8a8_matmul_stacked(xq, sx, w_q[None], s[None], 0,
                                        x.dtype),
               w8a8.w8a8_matmul_stacked_plain(xq, sx, w_q[None], s[None], 0,
                                              x.dtype), True)
    del x, w_q, s, xq, sx
    x, _, w_q, xq = w8a8_probe2.inputs(CARD)
    probe_pair("w8a8_probe2 W8A8 M=32768 K=N=4096",
               w8a8_probe2.w8a8_body(x, w_q),
               w8a8.w8a8_matmul_stacked_plain(
                   *w8a8.w8a8_quant_plain(x), w_q[None],
                   w8a8_probe2._col_scale(w_q, 0.001), 0, x.dtype), True)
    got = w8a8_probe2.int8_pure_body(xq, w_q)
    acc = w8a8.int_product(xq, w_q)
    want = (acc >> 8).to(torch.int8)
    off = (got.to(torch.int32) - want.to(torch.int32)) % 256
    off = torch.minimum(off, 256 - off)            # int8 wraps
    big = acc.abs() >= 2 ** 24
    if int(off.max()) > 1 or bool((off[~big] != 0).any()):
        raise AssertionError("w8a8_probe2 int8_pure_body: the shift moved "
                             "by more than the float32 rounding of the sum")
    log(f"probes: w8a8_probe2 int8_pure_body (W8A8-mm, unit scales, floor) "
        f"against int_product >> 8: {int((off != 0).sum())} of "
        f"{off.numel()} one apart, all at |sum| >= 2^24 "
        f"({int(big.sum())} such sums)")
    del x, w_q, xq, got, acc, want, off, big
    for name, K, N in w8a8_probe3.SHAPES:
        x, _, w_q, s = w8a8_probe3.inputs(K, N, CARD)
        probe_pair(f"w8a8_probe3 K1 {name}", w8a8_probe3.convert_body(
            x, w_q, s), k1.int8_matmul_stacked_plain(x, w_q[None], s[None],
                                                     0))
        probe_pair(f"w8a8_probe3 W8A8 {name}",
                   w8a8_probe3.w8a8_body(x, w_q, s),
                   w8a8.w8a8_matmul_stacked_plain(
                       *w8a8.w8a8_quant_plain(x), w_q[None], s[None], 0,
                       x.dtype), True)
        del x, w_q, s


def probe_checks_int4kv(smi):
    """One step of the bf16 and INT8 caches at int4kv_probe's shape: K2
    bf16 and K2 INT8 within TOL, K5 fused bit for bit; then K2 of each
    cache timed beside its plain version and SDPA on the (dequantized)
    cache, and the fused K5 beside its plain version and the unfused
    sequence, each with its bound, as one JSON line."""
    q, Kf, Vf, scales, (k8, v8), _ = int4kv_probe.inputs(CARD)
    mask = int4kv_probe._full_mask(1, int4kv_probe.CAP, CARD)
    probe_pair("int4kv_probe K2 bf16 B=128 H=16 cap=640",
               k2.decode_attention_stacked(q, Kf[None], Vf[None], 0, mask),
               k2.decode_attention_stacked_plain(q, Kf[None], Vf[None], 0,
                                                 mask))
    newk = q[:, :, 0, :] * 0.5
    pools = [k8[None].clone(), scales[None].clone()]
    got = kp.paged_quantize_write_int8(pools[0], pools[1], pools[0],
                                       pools[1], 0, None, 5, newk, newk)
    plain = [k8[None].clone(), scales[None].clone()]
    want = kp.paged_quantize_write_int8_plain(plain[0], plain[1], plain[0],
                                              plain[1], 0, None, 5, newk,
                                              newk)
    probe_pair("int4kv_probe K5 fused (K's buffers twice)", got, want, True)
    probe_pair("int4kv_probe K2 INT8",
               k2.decode_attention_int8_stacked(q, pools[0], pools[1],
                                                v8[None], scales[None], 0,
                                                mask),
               k2.decode_attention_int8_stacked_plain(
                   q, pools[0], pools[1], v8[None], scales[None], 0, mask))
    B, H, cap, D = Kf.shape
    sdpa = torch.nn.functional.scaled_dot_product_attention
    kd, vd = (quant.dequantize_kv(t, scales, q.dtype) for t in (k8, v8))
    ops = 4 * B * H * cap * D
    rows_ = {}
    for name, fn, plain, lib, row_bytes in (
            ("K2 bf16", lambda: k2.decode_attention_stacked(
                q, Kf[None], Vf[None], 0, mask),
             lambda: k2.decode_attention_stacked_plain(
                 q, Kf[None], Vf[None], 0, mask),
             lambda: sdpa(q, Kf, Vf), 2 * D),
            ("K2 INT8", lambda: k2.decode_attention_int8_stacked(
                q, k8[None], scales[None], v8[None], scales[None], 0, mask),
             lambda: k2.decode_attention_int8_stacked_plain(
                 q, k8[None], scales[None], v8[None], scales[None], 0, mask),
             lambda: sdpa(q, kd, vd), D + 4)):
        rows_[name] = {"ms": time_ms(fn, 20), "plain_ms": time_ms(plain, 5),
                       "library_ms": time_ms(lib, 20), "bound": bound(
                           2 * B * H * cap * row_bytes
                           + 2 * q.numel() * q.element_size(), ops)}
    k5_args = (k8[None], scales[None], k8[None], scales[None], 0, None, 5,
               newk, newk)
    rows_["K5 fused"] = {
        "ms": time_ms(lambda: kp.paged_quantize_write_int8(*k5_args), 20),
        "plain_ms": time_ms(lambda: kp.paged_quantize_write_int8_plain(
            *k5_args), 5),
        "library_ms": None,
        "unfused_ms": time_ms(lambda: unfused_k5(k5_args[:4], 0, None, 5,
                                                 newk, newk), UNFUSED_ITERS),
        "bound": bound(*quantize_bound(B, H, D, newk.element_size(), B),
                       FP32_FLOPS)}
    log(json.dumps({"int4kv_probe_rows": rows_, "shape": [B, H, cap, D],
                    "card": smi}))


def probe_checks_microbench():
    """Each kernel of kernel_microbench against its plain version on the
    probe's own inputs: K1 / K4 at its five M = 256 shapes, K2 INT8 at B =
    256 and 64, K3 causal at Q = 2048."""
    mb = kernel_microbench
    for L, M, K, N in ((12, 256, 2048, 6144), (12, 256, 2048, 2048),
                       (12, 256, 2048, 8192), (12, 256, 8192, 2048),
                       (1, 256, 2048, 50304)):
        for kind, inputs, variants in (
                ("K1", mb.int8_matmul_inputs, mb.int8_matmul_variants),
                ("K4", mb.int4_matmul_inputs, mb.int4_matmul_variants)):
            x, w, s = inputs(L, M, K, N, torch.bfloat16, CARD)
            v = variants(x, w, s)
            last = w.shape[0] - 1
            probe_pair(f"kernel_microbench {kind} M{M} K{K} N{N}",
                       v["kernel"](x, last), v["plain"](x, last))
            del x, w, s, v
    for B in (256, 64):
        q, kq, ks, vq, vs, mask = mb.decode_attention_inputs(
            12, B, 16, 640, 128, 1, torch.bfloat16, CARD)
        last = kq.shape[0] - 1
        probe_pair(f"kernel_microbench K2 INT8 B{B} cap640",
                   k2.decode_attention_int8_stacked(q, kq, ks, vq, vs, last,
                                                    mask),
                   k2.decode_attention_int8_stacked_plain(q, kq, ks, vq, vs,
                                                          last, mask))
        del q, kq, ks, vq, vs
    q, k, v, mask = mb.flash_prefill_inputs(8, 16, 2048, 128, torch.bfloat16,
                                            CARD)
    probe_pair("kernel_microbench K3 causal B8 Q2048",
               k3.flash_attention(q, k, v, mask),
               k3.flash_attention_plain(q, k, v, mask))
    torch.cuda.empty_cache()


def probe_checks_models(cfg):
    """The model probes' kernels at their shapes, random data: W8A8 bit
    for bit at prefill_profile's M (64 x 128 rows) and mixed48's prefill
    (128 x 512), K3 at prefill_profile's fresh query tile (128 of 512
    blocks, block-causal), K1 and K4 (g128) at mixed48's decode M = 128, K8
    bit for bit at paged_admit_probe's admission (16 rows of 3 pages of
    256: the engine shape), K2 INT8 at engine_cpu_ratio's cache (16 rows,
    8 heads of 32, 82 slots)."""
    g = torch.Generator(device=CARD).manual_seed(22)
    H, D = cfg.block_decoder.num_heads, cfg.block_decoder.head_dim
    ph = cfg.embedder.projection_hidden_size
    for label, M in (("prefill_profile", 64 * 128),
                     ("mixed48_stage_probe prefill", 128 * 512)):
        x = torch.randn((M, ph), generator=g, device=CARD).to(torch.bfloat16)
        w_q, scale = quant.quantize_int8(torch.randn(
            (1, ph, 3 * ph), generator=g, device=CARD))
        probe_pair(f"{label} W8A8 qkv M={M}", w8a8_pair(x, w_q, scale, 0),
                   w8a8.w8a8_matmul_stacked_plain(
                       *w8a8.w8a8_quant_plain(x), w_q, scale, 0, x.dtype),
                   True)
        del x, w_q, scale
    B, S, T = 64, 512, 128
    qkv = torch.randn((3, B, H, S, D), generator=g, device=CARD).to(
        torch.bfloat16)
    full = masks.block_decode_mask(0, S, S, torch.ones(
        (B, S), dtype=torch.int32, device=CARD), cfg.n_embedding_tokens)
    tile = masks.AttnMask(full.q_idx[S - T:], full.kv_idx, full.kv_valid)
    probe_pair(f"prefill_profile K3 B={B} Q={T} of K={S}",
               k3.flash_attention(qkv[0][:, :, S - T:].contiguous(), qkv[1],
                                  qkv[2], tile),
               k3.flash_attention_plain(qkv[0][:, :, S - T:], qkv[1], qkv[2],
                                        tile))
    del qkv
    x = torch.randn((128, ph), generator=g, device=CARD).to(torch.bfloat16)
    w = torch.randn((1, ph, 4 * ph), generator=g, device=CARD) * 0.02
    w_q, scale = quant.quantize_int8(w)
    probe_pair("mixed48_stage_probe K1 mlp_up M=128",
               k1.int8_matmul_stacked(x, w_q, scale, 0),
               k1.int8_matmul_stacked_plain(x, w_q, scale, 0))
    w_p, s4 = quant.quantize_int4(w, group_size=GROUP_SIZE)
    probe_pair("mixed48_stage_probe K4 mlp_up M=128 g128",
               k1.int4_matmul_stacked(x, w_p, s4, 0),
               k1.int4_matmul_stacked_plain(x, w_p, s4, 0))
    del x, w, w_q, scale, w_p, s4
    pools, pt, (L, B, H, D, ps, n_virt, P) = engine_pool_case(g, cfg)
    src = random_pools(g, L, B, H, n_virt * ps, D)
    exact("paged_admit_probe K8", kp.paged_page_copy_int8(
        *clones(pools), pt, *src), kp.paged_page_copy_int8_plain(
        *clones(pools), pt, *src), skip_page0=True)
    log("probes: paged_admit_probe K8 G=16 nv=3 ps=256: bit for bit")
    del pools, src
    small = config.get_config("block_main_b4_5").block_decoder
    cache = int8_layers(g, small.num_layers, 16, small.num_heads, 82,
                        small.head_dim)
    q = torch.randn((16, small.num_heads, 1, small.head_dim), generator=g,
                    device=CARD).to(torch.bfloat16)
    mask = masks.decode_mask(80, 82, 1, device=CARD)
    probe_pair("engine_cpu_ratio K2 INT8 B=16 H=8 D=32 cap=82",
               k2.decode_attention_int8_stacked(q, *cache, 0, mask),
               k2.decode_attention_int8_stacked_plain(q, *cache, 0, mask))
    torch.cuda.empty_cache()


def probe_step(name: str, fn, argv):
    """A probe's ``main(argv)`` in a launch window of its own (``script_
    step``), its seconds and launches kept for the phase's line."""
    report, launches = script_step(probe_secs, name, fn, argv,
                                   f"probe {name}")
    probe_launches[name] = {k: v for k, v in launches.items() if v}
    log(json.dumps({"probe": name, "launches": probe_launches[name],
                    "routes": {t: dict(f.route_launches) for t, (f, _)
                               in ROUTED.items() if launches[t]}}))
    return report


def quality_w8a8_decode_gate(block_dir, holdout, work, smi) -> dict:
    """``w8a8_decode_gate`` on ``phase_quality``'s trained checkpoint at its
    defaults (batch 384: decode M reaches the W8A8 window), a launch window
    of its own; raises unless both variants scored finite logprobs. Its
    kernels' shapes are ``quality_kernel_rows``' decode-gate rows (W8A8-mm
    bit for bit at M = 384)."""
    report = probe_step("w8a8_decode_gate", w8a8_decode_gate.main, [
        "--model_dir", block_dir, "--corpus", holdout, "--batch",
        W8A8_GATE_BATCH, "--out", os.path.join(work, "w8a8_gate.json")])
    log(json.dumps({"w8a8_decode_gate": report, "card": smi}))
    finite("w8a8_decode_gate", report["fp32_mean_logprob_w8a8_on"],
           report["fp32_mean_logprob_w8a8_off"])
    return report


def phase_probes(smi) -> dict:
    """The speed probes through their ``main(argv)`` on the card at the
    1.2b widths (``w8a8_decode_gate`` runs in ``phase_quality`` on its
    trained checkpoint), each first held against the plain versions at its
    shapes (``probe_checks_*``, outside the launch windows), then run in a
    launch window of its own (``probe_step``: every kernel of the probe
    launched, none it must not); finite figures asserted. Returns {path:
    launches}."""
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_probes_",
                            dir=os.path.join(ROOT, "build"))
    log(f"probes: cuts for time: kernel_microbench "
        f"{' '.join(PROBE_MICROBENCH)} (default 32); prefill_profile "
        f"{' '.join(PROBE_PREFILL)} (default 256); mixed48_stage_probe "
        f"ITERS {PROBE_MIXED48_ITERS} (default 32); paged_admit_probe "
        f"{' '.join(PROBE_ADMIT)} (defaults 3, 64); engine_cpu_ratio "
        f"{' '.join(PROBE_RATIO)} (default 3); the rest at their defaults")
    started = time.perf_counter()
    cfg = config.get_config(MODEL)
    try:
        t0 = time.perf_counter()
        probe_checks_w8a8()
        probe_checks_int4kv(smi)
        probe_checks_microbench()
        probe_checks_models(cfg)
        torch.cuda.synchronize()
        checks_s = time.perf_counter() - t0
        rows = {}
        for name, mod in (("w8a8_probe", w8a8_probe),
                          ("w8a8_probe2", w8a8_probe2),
                          ("w8a8_probe3", w8a8_probe3),
                          ("int4kv_probe", int4kv_probe)):
            rows[name] = probe_step(name, mod.main, [])
        for r in (*rows["w8a8_probe"], *rows["w8a8_probe2"],
                  *rows["int4kv_probe"]):
            finite(str(r), r["ms_per_iter" if "ms_per_iter" in r
                             else "ms_per_step"])
        for r in rows["w8a8_probe3"]:
            finite(r["shape"], *(r[k]["ms_per_iter"] for k in (
                "bf16", "int8w_convert", "w8a8")))
        mb = probe_step("kernel_microbench", kernel_microbench.main, [
            *PROBE_MICROBENCH, "--out", os.path.join(work, "mb.json")])
        finite("kernel_microbench", *(r["us"] for r in mb["results"]))
        pf = probe_step("prefill_profile", prefill_profile.main,
                        PROBE_PREFILL)
        finite("prefill_profile", *(v["device_s"] for v in
                                    pf["stages"].values()))
        if pf["matmul_floor_route"] != "W8A8-mm":
            raise AssertionError(f"prefill_profile's matmul floor took "
                                 f"{pf['matmul_floor_route']}, not W8A8")
        iters, bench.ITERS = bench.ITERS, PROBE_MIXED48_ITERS
        try:
            m48 = probe_step("mixed48_stage_probe", mixed48_stage_probe.main,
                             [])
        finally:
            bench.ITERS = iters
        finite("mixed48_stage_probe", *(v for d in (m48["int8"],
                                                    m48["mixed48"])
                                        for v in d.values()))
        adm = probe_step("paged_admit_probe", paged_admit_probe.main, [
            *PROBE_ADMIT, "--out", os.path.join(work, "admit.json")])
        finite("paged_admit_probe", adm["page_copy_s"],
               adm["paged"]["window_fit"]["fixed_per_dispatch_s"])
        ratio = probe_step("engine_cpu_ratio", engine_cpu_ratio.main, [
            *PROBE_RATIO, "--out", os.path.join(work, "ratio.json")])
        finite("engine_cpu_ratio", ratio["engine_pct_of_static"])
        log(json.dumps({"probes": {
            **rows, "kernel_microbench": mb, "prefill_profile": pf,
            "mixed48_stage_probe": m48, "paged_admit_probe": adm,
            "engine_cpu_ratio": ratio}, "card": smi}))
    finally:
        shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()
    log(json.dumps({"probes_phase_s": time.perf_counter() - started,
                    "checks_s": checks_s, "steps_s": probe_secs,
                    "launches": probe_launches, "card": smi}))
    return {f"probe {n}": v for n, v in probe_launches.items()}


# ---------------------------------------------------------------------------
# phase_bench: the port's benchmark (block_transformer_tpu_torch/bench.py)
# ---------------------------------------------------------------------------

BENCH_BATCH, BENCH_PREFILL, BENCH_DECODE = 16, 2048, 128
BENCH_REPS = 2                # BT_BENCH_REPS (default 5)
BENCH_ITERS = 16              # bench.ITERS, the decomposition's (32)
BENCH_ARGV = ["--model", MODEL, "--vanilla", VANILLA_MODEL,
              "--batch", BENCH_BATCH, "--vanilla_batch", BENCH_BATCH,
              "--prefill", BENCH_PREFILL, "--decode", BENCH_DECODE,
              "--quantize", "int8", "--kv", "int8", "--engine",
              "--engine_slots", BENCH_BATCH,
              "--detail_out", os.path.join(ROOT, "build", "BENCH_DETAIL.json")]
# the JAX benchmark's metric for this command line
BENCH_METRIC = (f"decode_tokens_per_sec[{MODEL}-int8-kv8 b{BENCH_BATCH} "
                f"p{BENCH_PREFILL}/d{BENCH_DECODE} vs {VANILLA_MODEL}-int8-kv8 "
                f"b{BENCH_BATCH}]")
BENCH_DETAIL_KEYS = {"block", "vanilla", "engine", "block_tok_per_s",
                     "vanilla_tok_per_s", "block_batch", "vanilla_batch",
                     "regime"}
BENCH_STAGES = ("prefill_ms", "token_decoder_ms_per_block_step",
                "block_decoder_ms_per_block_step")
# INT8 weights and caches throughout (the block model, its decomposition,
# the contiguous INT8 engine, the baseline): no INT4 weight, no paged pool,
# no bf16 global cache
PATH_KERNELS["bench"] = ("K1", "K2", "K2 bf16", "K3", *K5_FUSED, *W8A8)
PATH_ABSENT["bench"] = ("K4", "K6", "K6 int4", *K7_FUSED, "K8", "K8 int4")


def check_bench_engines(engines, rows, vocab: int) -> None:
    """Every request of every rep of both engine rows (and the warm-ups)
    served in full, with tokens in [0, vocab); each rep produced the same
    count."""
    for (kw, eng), row in zip(engines, rows):
        reqs = eng.completed
        if len(reqs) != BENCH_BATCH * (1 + BENCH_REPS):
            raise AssertionError(f"bench engine {kw}: {len(reqs)} requests "
                                 f"completed")
        for r in reqs:
            if r.error or not r.done or len(r.generated) != BENCH_DECODE:
                raise AssertionError(
                    f"bench engine: request {r.uid} served "
                    f"{len(r.generated)} of {BENCH_DECODE} tokens (error "
                    f"{r.error!r})")
            if min(r.generated) < 0 or max(r.generated) >= vocab:
                raise AssertionError("bench engine: tokens out of [0, vocab)")
        if row["engine_tokens"] != BENCH_BATCH * BENCH_DECODE or \
                row["latency"]["completed"] != BENCH_BATCH:
            raise AssertionError(f"bench engine: a rep produced "
                                 f"{row['engine_tokens']} tokens for "
                                 f"{row['latency']['completed']} requests")


def phase_bench(smi) -> dict:
    """``bench.main`` at ``block_main_b4_1.2b`` / ``vanilla_410`` width, B =
    16, p2048/d128, INT8 weights and KV, with the engine (16 slots),
    ``BT_BENCH_REPS`` = 2 and ``bench.ITERS`` = 16, in a launch window of its own (every kernel of
    the path launched, none it must not); its JSON line and detail file
    checked against the JAX benchmark's metric and keys, the engine's
    requests served in full. Returns {"bench": launches}."""
    started = time.perf_counter()
    log(f"bench: cuts for time: BT_BENCH_REPS {BENCH_REPS} (default 5), "
        f"the decomposition's ITERS {BENCH_ITERS} (default {bench.ITERS})")
    saved = os.environ.get("BT_BENCH_REPS")
    os.environ["BT_BENCH_REPS"] = str(BENCH_REPS)
    iters, bench.ITERS = bench.ITERS, BENCH_ITERS
    real = bench.engine_lib.ContinuousBatchingEngine
    engines = []

    class Engine(real):         # keeps the engines main builds
        def __init__(self, *args, **kw):
            engines.append((kw, self))
            super().__init__(*args, **kw)

    bench.engine_lib.ContinuousBatchingEngine = Engine
    try:
        record, launches = script_step({}, "bench", bench.main,
                                       BENCH_ARGV, "bench")
    finally:
        bench.engine_lib.ContinuousBatchingEngine = real
        bench.ITERS = iters
        if saved is None:
            os.environ.pop("BT_BENCH_REPS")
        else:
            os.environ["BT_BENCH_REPS"] = saved
    line = record["line"]
    with open(BENCH_ARGV[-1]) as f:
        detail = json.load(f)
    if line["metric"] != BENCH_METRIC or line["unit"] != "tok/s":
        raise AssertionError(f"bench line {line}")
    finite("bench", line["value"], line["vs_baseline"])
    if not (line["value"] > 0 and line["vs_baseline"] > 0):
        raise AssertionError(f"bench line {line}")
    if set(detail) != BENCH_DETAIL_KEYS or detail != json.loads(
            json.dumps(record["detail"])):
        raise AssertionError(f"bench detail keys {sorted(detail)}")
    block, engine = detail["block"], detail["engine"]
    if block.get("decomposition_batch") != BENCH_BATCH or any(
            k not in block for k in BENCH_STAGES):
        raise AssertionError(f"bench decomposition: {block}")
    finite("bench decomposition", *(block[k] for k in BENCH_STAGES))
    if "latency_mode_row" not in engine or "median_s" not in \
            detail["vanilla"]:
        raise AssertionError(f"bench engine / vanilla detail: "
                             f"{sorted(engine)} / {sorted(detail['vanilla'])}")
    check_bench_engines(engines, (engine, engine["latency_mode_row"]),
                        config.get_config(MODEL).vocab_size)
    torch.cuda.empty_cache()
    log(json.dumps({"bench": line, "detail": detail,
                    "launches": {k: v for k, v in launches.items() if v},
                    "bench_phase_s": time.perf_counter() - started,
                    "card": smi}))
    return {"bench": launches}


# ---------------------------------------------------------------------------
# phase_tp: serving over a (data, model) mesh (parallel/tp_decode.py)
# ---------------------------------------------------------------------------

TP_DIR = os.path.join(ROOT, "build", "chip_smoke_tp")
TP_BACKEND = {"cuda": "nccl", "cpu": "gloo"}    # (a)'s one rank
# the mesh paths: no W8A8 inside the TP programs (a row-parallel linear sees
# a K-slice of each row); K2 bf16 on the token decoder's local cache only
_NO_SERVING = ("K6", "K6 int4", *K7_FUSED, "K8", "K8 int4")
PATH_KERNELS.update({
    "tp generation": ("K1", "K2", "K2 bf16", "K3", *K5_FUSED),
    "tp generation int4": ("K2", "K2 bf16", "K3", "K4", *K5_FUSED),
    "tp engine int8": ("K1", "K2", "K2 bf16", "K3", *K5_FUSED),
    "tp engine paged": ("K1", "K2 bf16", "K3", "K6", *K7_FUSED, "K8"),
    "tp2 generation": ("K1", "K2", "K2 bf16", "K3", *K5_FUSED),
    "tp2 engine int8": ("K1", "K2", "K2 bf16", "K3", *K5_FUSED),
})
PATH_ABSENT.update({
    "tp generation": ("K4", *W8A8, *_NO_SERVING),
    "tp generation int4": ("K1", *W8A8, *_NO_SERVING),
    "tp engine int8": ("K4", *W8A8, *_NO_SERVING),
    "tp engine paged": ("K2", "K4", *K5_FUSED, *W8A8, "K6 int4", "K8 int4"),
    "tp2 generation": ("K4", *W8A8, *_NO_SERVING),
    "tp2 engine int8": ("K4", *W8A8, *_NO_SERVING),
})
# the collectives the TP programs issue: all_reduce SUM (layers, gathers),
# MAX and MIN (the top-1 pick), on these types
TP_COLLECTIVES = [(dt, op) for dt in ("float32", "bfloat16", "int32",
                                      "int64")
                  for op in ("SUM", "MAX", "MIN")]


def tp_generate(mesh, cfg, params, ids, att, bam, max_blocks):
    """The TP generator over ``mesh`` (INT8 global cache, greedy) from the
    whole tree; returns (tokens [B, max_blocks, L], n_blocks, seconds of
    the run, ``again(blocks)``, which runs it again to ``blocks``)."""
    from block_transformer_tpu_torch.parallel import tp_decode
    tp = tp_decode._axes(mesh).tp
    shards = tp_decode.shard_tp_params(
        mesh, tp_decode.prepare_tp_params(params, cfg, tp=tp))

    def fn(blocks):
        return tp_decode.make_tp_generate_blocks(
            mesh, cfg, shards, max_blocks=blocks, kv_cache="int8")(
                shards, ids, att, bam)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks, nb = fn(max_blocks)
    torch.cuda.synchronize()
    return toks, nb, time.perf_counter() - t0, fn


def host_ops(prof, top: int = 12) -> dict:
    """The ``top`` host ops of a torch.profiler run by self time: {name:
    (count, self ms in all)}."""
    evs = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    return {e.key[:60]: (e.count, round(e.self_cpu_time_total / 1e3, 3))
            for e in evs[:top]}


def allreduce_profile(run, ops: dict = None) -> dict:
    """Run ``run`` under torch.profiler; the all-reduces it issued: the
    host op (c10d's all-reduce, count and mean host us) and, on NCCL, its
    device kernel (count and mean device us). ``ops``, if given, takes the
    run's wall seconds and its top host ops (``host_ops``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    if ops is not None:
        ops.update(seconds=time.perf_counter() - t0, top=host_ops(prof))
    out = {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        low = name.lower()
        if "allreduce" not in low and "all_reduce" not in low:
            continue
        key = ("device " if e.device_type() == DeviceType.CUDA
               else "host ") + name[:60]
        n, us = out.get(key, (0, 0.0))
        out[key] = (n + 1, us + e.duration_ns() / 1e3)
    return {k: {"count": n, "mean_us": us / n} for k, (n, us) in out.items()}


def forced_logits(params, cfg, prompt, generated):
    """float32 logits [len(generated) + 1, V] at each generated position of
    one row and the one after, from one teacher-forced forward of the
    prompt blocks (``prompt``: ids and attention mask [N, L]) followed by
    ``generated``. The forward is the training path's (no cache; W8A8 off,
    as in the TP programs), a third way to the same logits."""
    ids, att = prompt
    N, L = ids.shape
    k = len(generated)
    nb = k // L + 1                     # the blocks holding positions 0..k
    gen_ids = np.zeros((nb * L,), np.int32)
    gen_ids[:k] = generated
    ids = np.concatenate([ids, gen_ids.reshape(nb, L)])[None]
    att = np.concatenate([att, np.ones((nb, L), att.dtype)])[None]
    dev = lambda a: torch.as_tensor(a, device=CARD)      # noqa: E731
    with torch.no_grad(), linear_ops.w8a8_disabled():
        logits = bt.block_transformer_forward(
            params, cfg, dev(ids), dev(att), dev(att.any(-1).astype(np.int32)),
            compute_logits=True).logits[0]
    # generated position i is block N + i // L's token i % L, predicted
    # from block N + i // L - 1
    return logits[N - 1:N - 1 + nb].reshape(nb * L, -1)[:k + 1].float()


def check_tokens(what, params, cfg, prompts, got, want, budgets) -> dict:
    """Every greedy token of a path (``got``: a list of tokens per row, EOS
    and what follows it already cut) against a teacher-forced forward of
    the row's own tokens (``forced_logits``): each token's logit must lie
    within TOL * max|logit| of the best one at its position, and a row
    shorter than its budget (it ended at EOS) must have EOS there at the
    position after its last token. Where a row parts from ``want`` (one
    device, or (a)), the other token must lie as near the best at that
    position (the prefix is the same there). Logs the rows equal to
    ``want``, where the others part, the positions checked, the largest
    gap against its limit, and the band (vocab entries within the limit)
    at each checked position, which says how much the check constrains."""
    eos = cfg.eos_token_id
    equal, n_pos, bands, worst, parted = 0, 0, [], 0.0, []
    for r, (x, y) in enumerate(zip(got, want)):
        x = list(map(int, x))
        picks = x + ([eos] if len(x) < budgets[r] else [])
        logits = forced_logits(params, cfg, prompts[r], x)[:len(picks)]
        best = logits.max(-1).values
        limit = TOL * logits.abs().max(-1).values
        gap = best - logits.gather(
            -1, torch.tensor(picks, device=logits.device)[:, None])[:, 0]
        # at the first difference from ``want`` the prefix is the same: its
        # token must be as near the best there
        y = list(map(int, y))
        other = y + ([eos] if len(y) < budgets[r] else [])
        k = next((i for i, (p, q) in enumerate(zip(picks, other)) if p != q),
                 None)
        if k is None:
            equal += len(picks) == len(other)
        else:
            gap_y = best[k] - logits[k, other[k]]
            parted.append((r, k))
            if gap_y > limit[k]:
                raise AssertionError(
                    f"{what}: row {r} parts at generated token {k} outside "
                    f"a near-tie: {picks[k]} / {other[k]}, gap of the other "
                    f"{gap_y.item():.5f} > {limit[k].item():.5f}")
        bad = (gap > limit).nonzero()
        if len(bad):
            i = int(bad[0, 0])
            raise AssertionError(
                f"{what}: row {r} generated token {i} ({picks[i]}) is "
                f"{gap[i].item():.5f} below the best logit "
                f"{best[i].item():.5f}, past the limit TOL * max|logit| = "
                f"{limit[i].item():.5f}")
        n_pos += len(picks)
        worst = max(worst, (gap / limit).max().item())
        bands += (logits >= (best - limit)[:, None]).sum(-1).tolist()
    bands = np.asarray(bands)
    out = {"rows": len(got), "rows_equal": equal,
           "parted_at (row, token)": parted, "positions": n_pos,
           "max_gap_over_limit": round(worst, 5),
           "band_1": int((bands == 1).sum()),
           "band_mean": round(float(bands.mean()), 3),
           "band_max": int(bands.max())}
    log(f"{what}: every generated token within TOL * max|logit| of the best "
        f"logit of a teacher-forced forward over the row's own tokens: "
        f"{json.dumps(out)}")
    return out


def generation_rows(cfg, tokens, ids, att, N):
    """(prompts, generated rows, EOS and what follows cut) of a
    generation's tokens [B, blocks, L] (EOS comes out as pad there)."""
    toks = tokens.cpu().numpy()
    rows = []
    for b in range(len(toks)):
        row = toks[b, N:].reshape(-1)
        end = np.flatnonzero(row == cfg.pad_token_id)
        rows.append(row[:end[0]] if len(end) else row)
    return [(ids[b], att[b]) for b in range(len(toks))], rows


def engine_prompts(cfg, requests):
    """Each engine request's prompt in block format (left pad)."""
    out = []
    for prompt, _ in requests:
        d = gen.preprocess_inputs(cfg, prompt[None])
        out.append((d["input_ids"][0], d["attention_mask"][0]))
    return out


def tp_engine_run(mesh, cfg, params, kind, path):
    """Serve the engine traffic over ``mesh`` (or, ``path`` None, on one
    device), W8A8 off; returns (each request's tokens, the requests, the
    path's launches, asserted; None on one device)."""
    eng = pg.make_engine(params, cfg, kind, mesh=mesh)
    requests = pg.engine_requests(cfg, seed=0)
    reset_launches()
    with linear_ops.w8a8_disabled():
        res = pg.serve(eng, requests)
    launches = None if path is None else read_launches(path)
    for r, (_, budget) in zip(res["requests"], requests):
        if r.error or not r.done or not 1 <= len(r.generated) <= budget:
            raise AssertionError(f"{path or kind}: request {r.uid} served "
                                 f"{len(r.generated)} of {budget} tokens")
    if kind.startswith("paged") and (
            [sorted(f) for f in eng._free_pages]
            != [list(range(1, eng.pool_pages // eng._dp))]
            or bool(eng.cache.page_table.any())):
        raise AssertionError(f"{path}: pages were not all freed")
    log(f"{MODEL} engine {kind} {'over the mesh' if mesh else 'one device'}"
        f": {len(res['requests'])} requests, {res['tokens']} tokens in "
        f"{res['seconds']:.3f} s ({res['dispatches']} dispatches)")
    return [r.generated for r in res["requests"]], requests, launches


def tp2_rank(rank: int, store: str, out: str) -> None:
    """Rank ``rank`` of (b): two processes on the one card, gloo with CUDA
    tensors, mesh (data 1, model 2), each rank 8 of the 16 heads. Checks
    the collectives the programs issue, then the TP generator (INT8,
    greedy) and ``engine int8``; saves tokens, launches and all-reduce
    times to ``out``."""
    import torch.distributed as dist
    from block_transformer_tpu_torch.parallel import sharding
    if CARD == "cuda":
        torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=2)
    try:
        coll = {}
        for dt, op in TP_COLLECTIVES + [("float32", "all_gather")]:
            t = torch.arange(4, device=CARD).to(getattr(torch, dt)) + rank
            if op == "all_gather":
                parts = [torch.empty_like(t) for _ in range(2)]
                dist.all_gather(parts, t)
                ok = torch.equal(parts[1] - parts[0], torch.ones_like(t))
            else:
                dist.all_reduce(t, op=getattr(dist.ReduceOp, op))
                want = torch.arange(4, device=CARD).to(t.dtype)
                want = {"SUM": 2 * want + 1, "MAX": want + 1,
                        "MIN": want}[op]
                ok = torch.equal(t, want)
            coll[f"{op} {dt}"] = bool(ok)
        if rank == 0:
            log(json.dumps({"gloo_cuda_collectives": coll,
                            "torch": torch.__version__}))
        if not all(coll.values()):
            raise AssertionError(f"gloo on CUDA tensors: {coll}")
        mesh = sharding.make_mesh(1, 2, device=CARD)
        cfg, params = pg.main_path_model(seed=0, quantize="int8")
        ids, att, bam = pg.ragged_prompts(cfg, BATCH, PROMPT_TOKENS, seed=0)
        max_blocks = ids.shape[1] + NEW_TOKENS // cfg.block_length
        reset_launches()
        toks, nb, secs, again = tp_generate(mesh, cfg, params, ids, att, bam,
                                            max_blocks)
        launches = {"tp2 generation": read_launches("tp2 generation")}
        ar = allreduce_profile(lambda: again(ids.shape[1] + 2))
        del again
        tokens, _, launches["tp2 engine int8"] = tp_engine_run(
            mesh, cfg, params, "int8", "tp2 engine int8")
        torch.save({"tokens": toks.cpu(), "n_blocks": nb, "seconds": secs,
                    "engine": tokens, "launches": launches,
                    "allreduce": ar}, out)
    finally:
        dist.destroy_process_group()


def phase_tp(rows, smi: str) -> dict:
    """Serving over a (data, model) mesh at full width (``MODEL``, random
    bf16 weights from a seed, B=8 ragged prompts of 2048, 128 new tokens;
    the engine traffic at the smoke's shapes). (a) One rank in this
    process, NCCL, mesh (data 1, model 1): the TP generator with INT8 and
    with INT4 weights (INT8 cache) and the engine over ``int8`` and
    ``paged``, every generated token checked against a teacher-forced
    forward (``check_tokens``; W8A8 off, as the TP programs take none) and
    the rows equal to this port on one device counted, launches asserted
    by route. (b) Two ranks on the one card (NCCL refuses two ranks on one
    device: gloo with CUDA tensors), mesh (data 1, model 2): the generator
    (INT8) and ``engine int8``, the ranks' tokens equal, checked the same
    way and counted against (a). Then K1
    and K2 rows at the tp = 2 shard widths, and each rank's all-reduce a
    layer from a trace. Returns the launches of each path."""
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from block_transformer_tpu_torch.parallel import sharding
    t_phase = time.perf_counter()
    shutil.rmtree(TP_DIR, ignore_errors=True)
    os.makedirs(TP_DIR)
    launches = {}
    dist.init_process_group(TP_BACKEND[CARD], store=dist.FileStore(
        os.path.join(TP_DIR, "store_a"), 1), rank=0, world_size=1)
    try:
        mesh = sharding.make_mesh(1, 1, device=CARD)
        ar = {}
        for quantize in ("int8", "int4"):
            cfg, params = pg.main_path_model(seed=0, quantize=quantize)
            ids, att, bam = pg.ragged_prompts(cfg, BATCH, PROMPT_TOKENS,
                                              seed=0)
            N = ids.shape[1]
            max_blocks = N + NEW_TOKENS // cfg.block_length
            with linear_ops.w8a8_disabled():
                ref = gen.generate_blocks(params, cfg, ids, att, bam,
                                          max_blocks=max_blocks,
                                          kv_cache="int8", device=CARD)
            path = ("tp generation" if quantize == "int8"
                    else "tp generation int4")
            reset_launches()
            toks, nb, secs, again = tp_generate(mesh, cfg, params, ids, att,
                                                bam, max_blocks)
            launches[path] = read_launches(path)
            if nb != ref.n_blocks or tuple(toks.shape) != tuple(
                    ref.tokens.shape):
                raise AssertionError(f"{path}: {nb} blocks, one device "
                                     f"{ref.n_blocks}")
            if not torch.equal(toks[:, :N].cpu(), torch.from_numpy(ids)):
                raise AssertionError(f"{path}: prompt blocks not kept")
            prompts, got = generation_rows(cfg, toks, ids, att, N)
            budgets = [(max_blocks - N) * cfg.block_length] * len(got)
            check_tokens(f"{path} (tp=1), rows equal to one device's",
                         params, cfg, prompts, got,
                         generation_rows(cfg, ref.tokens, ids, att, N)[1],
                         budgets)
            log(f"{path} mesh (data 1, model 1), NCCL: {nb - N} blocks "
                f"generated in {secs:.3f} s")
            if quantize == "int8":
                # where the time of tp=1 goes against one device: the
                # prefill and two blocks of each, traced on the host
                ops = {"tp=1": {}, "one device": {}}
                ar["tp=1 NCCL generation"] = allreduce_profile(
                    lambda: again(N + 2), ops["tp=1"])
                with linear_ops.w8a8_disabled():
                    allreduce_profile(lambda: gen.generate_blocks(
                        params, cfg, ids, att, bam, max_blocks=N + 2,
                        kv_cache="int8", device=CARD), ops["one device"])
                log(json.dumps({"host_ops_prefill_and_2_blocks": ops,
                                "card": smi}))
                a_rows = got
                for kind in ("int8", "paged"):
                    want, requests, _ = tp_engine_run(None, cfg, params,
                                                      kind, None)
                    path = f"tp engine {kind}"
                    tokens, _, launches[path] = tp_engine_run(
                        mesh, cfg, params, kind, path)
                    check_tokens(f"{path} (tp=1), rows equal to one "
                                 "device's", params, cfg,
                                 engine_prompts(cfg, requests), tokens, want,
                                 [m for _, m in requests])
                    if kind == "int8":
                        a_engine = tokens
                int8_params, int8_cfg = params, cfg
            else:
                del params
            del again
    finally:
        dist.destroy_process_group()
    log(f"phase_tp (a) {time.perf_counter() - t_phase:.1f} s")

    t0 = time.perf_counter()
    outs = [os.path.join(TP_DIR, f"b_{r}.pt") for r in range(2)]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=tp2_rank, args=(r, os.path.join(
        TP_DIR, "store_b"), outs[r])) for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=600)
    for r, p in enumerate(procs):
        if p.is_alive():
            p.kill()
            p.join()
        if p.exitcode != 0:
            raise AssertionError(f"(b) rank {r} exited {p.exitcode}")
    b = [torch.load(o, weights_only=False) for o in outs]
    cfg, params = int8_cfg, int8_params
    ids, att, _ = pg.ragged_prompts(cfg, BATCH, PROMPT_TOKENS, seed=0)
    N = ids.shape[1]
    # every rank returns every row: the ranks' tokens are one result
    if not (torch.equal(b[0]["tokens"], b[1]["tokens"])
            and b[0]["engine"] == b[1]["engine"]):
        raise AssertionError("(b): the two ranks returned different tokens")
    prompts, got = generation_rows(cfg, b[0]["tokens"], ids, att, N)
    check_tokens("tp2 generation, rows equal to (a)'s", params, cfg, prompts,
                 got, a_rows, [(b[0]["tokens"].shape[1] - N)
                               * cfg.block_length] * len(got))
    requests = pg.engine_requests(cfg, seed=0)
    check_tokens("tp2 engine int8, rows equal to (a)'s", params, cfg,
                 engine_prompts(cfg, requests), b[0]["engine"], a_engine,
                 [m for _, m in requests])
    for r, res in enumerate(b):
        launches[f"tp2 generation rank {r}"] = res["launches"][
            "tp2 generation"]
        ar[f"tp=2 gloo rank {r} generation"] = res["allreduce"]
        log(f"tp2 generation rank {r}, mesh (data 1, model 2), gloo on CUDA "
            f"tensors: {res['n_blocks'] - N} blocks in {res['seconds']:.3f} "
            f"s; launches {json.dumps(res['launches'])}")
    launches["tp2 generation"] = b[0]["launches"]["tp2 generation"]
    log(f"phase_tp (b) {time.perf_counter() - t0:.1f} s")
    log(json.dumps({"tp_allreduce_per_layer": ar, "card": smi}))

    # kernel rows at the tp = 2 shard widths (each rank's shapes)
    g = torch.Generator(device=CARD).manual_seed(18)
    bcfg = cfg.block_decoder
    h, m, V = bcfg.hidden_size, bcfg.intermediate_size, cfg.vocab_size
    for label, M, K, N_, layers in (
            ("tp=2 qkv M=8", 8, h, 3 * h // 2, 12),
            ("tp=2 attn_out M=8", 8, h // 2, h, 12),
            ("tp=2 mlp_down M=8", 8, m // 2, h, 12),
            ("tp=2 lm_head M=8", 8, h, V // 2, 1)):
        k1_row(rows, g, label, M, K, N_, layers, path="tp2 generation")
    H, D, cap, filled = bcfg.num_heads // 2, bcfg.head_dim, 640, 530
    cache = int8_layers(g, 12, BATCH, H, cap, D)
    q = torch.randn((BATCH, H, 1, D), generator=g, device=CARD,
                    dtype=torch.bfloat16)
    valid = torch.zeros((BATCH, cap), dtype=torch.int32, device=CARD)
    for bb in range(BATCH):
        valid[bb, 16 * bb:filled] = 1
    valid[0] = 0
    k2_row(rows, f"tp=2 B=8 H={H} S=1 D={D} cap={cap}", cache, q,
           masks.block_decode_mask(filled - 1, cap, 1, valid), 100,
           path="tp2 generation")
    del cache, int8_params, params
    shutil.rmtree(TP_DIR, ignore_errors=True)
    log(f"phase_tp total {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase_tp_train: training over a mesh (train/train_step.py's sharded steps,
# parallel/pipeline.py, the Trainer's mesh)
# ---------------------------------------------------------------------------

TP_TRAIN_DIR = os.path.join(ROOT, "build", "chip_smoke_tp_train")
TP_TRAIN_SEQS = 4       # rows of TRAIN_TOKENS tokens in a global batch
# (b) against (a), relative, each step: the loss, and the grad norm (which
# bf16 rounding moves more); a wrong update reads as a loss gap of ~6e-3
TP_TRAIN_RTOL = {"loss": 1e-3, "grad_norm": 5e-3}
TP_TRAIN_MICRO = 4      # the pipeline's micro-batches
# no warmup: step 1 moves every parameter (by ~1e-3, Adam's first step),
# so step 2's loss and grad norm read the sharded update
TP_TRAIN_LR = dict(peak_lr=1e-3, warmup_steps=0, total_steps=10)
# (b)'s mesh shapes over two ranks: make_mesh's keywords or (shape, names)
TP_TRAIN_SHAPES = {"data 2": dict(n_data=2, n_model=1),
                   "model 2": dict(n_data=1, n_model=2),
                   "pipe 2": ((1, 2), ("data", "pipe"))}
TP_TRAINER_LAYERS = 1   # (c)'s depth a stack (full width)
TP_TRAIN_LAYERS = 6     # the phase's depth a stack (full width): gloo's
                        # all-reduce of the float32 gradient sets (b)'s
                        # step time, so half the depth halves it
GLOO_RATE_GIB = (1,)    # float32 CUDA tensors all-reduced over gloo


def _sync(card: str) -> None:
    if card == "cuda":
        torch.cuda.synchronize()


def _peak_gib(card: str) -> float:
    return torch.cuda.max_memory_allocated() / 2**30 if card == "cuda" \
        else 0.0


def _reset_peak(card: str) -> None:
    if card == "cuda":
        torch.cuda.reset_peak_memory_stats()


def tp_train_batches(cfg):
    """The two steps' global batch: TP_TRAIN_SEQS rows of random tokens
    (row 1 left-padded), seed 0, the same at both steps, so that step 2's
    loss and grad norm read step 1's update on the batch it was made from
    (a wrong update shows there as a loss gap of ~1e-2)."""
    batch = train_batch(cfg, seed=0, tokens=TRAIN_TOKENS, rows=TP_TRAIN_SEQS)
    return [batch, batch]


def leaf_checksums(tree) -> dict:
    """{path: (dtype, shape, sum, weighted sum)} of every leaf's bits (an
    integer view), on its device: equal trees give equal checksums."""
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    out = {}
    for path, t in opt.tree_items(tree):
        v = t.contiguous().view(ints[t.element_size()]).reshape(-1).long()
        w = torch.arange(v.numel(), device=v.device) % 65521 + 1
        out[path] = (str(t.dtype), tuple(t.shape), int(v.sum()),
                     int((v * w).sum()))
    return out


def state_checksums(state) -> dict:
    """``leaf_checksums`` of the parameters and both moments."""
    o = state.opt_state
    return {"params": leaf_checksums(state.params),
            "mu": leaf_checksums(o.mu), "nu": leaf_checksums(o.nu)}


def collective_trace(run) -> dict:
    """Run ``run`` under torch.profiler (host only); the collectives it
    issued by name: count and host ms in all."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    out = {}
    for e in prof.key_averages():
        low = e.key.lower()
        if any(k in low for k in ("all_reduce", "allreduce", "all_gather",
                                  "allgather", "barrier", "broadcast")):
            out[e.key[:48]] = {"count": e.count, "host_ms": round(
                e.cpu_time_total / 1e3, 3)}
    return out


def tp_train_run(card, state, step, batches, what, trace=False,
                 checks=None) -> list:
    """``step(state, batch) -> (state, loss, grad_norm)`` over ``batches``
    (the second traced when ``trace``): each step's loss, grad norm, host
    seconds (the device synchronized; the trace's own processing after the
    step left out), peak memory and, after it, ``checks(state)``."""
    out = []
    for i, batch in enumerate(batches):
        _sync(card)
        _reset_peak(card)
        rec = {}

        def one():
            nonlocal state
            t0 = time.perf_counter()
            state, loss, norm = step(state, batch)
            rec.update(loss=float(loss), grad_norm=float(norm))
            _sync(card)
            rec["s"] = time.perf_counter() - t0

        if trace and i == 1:
            rec["collectives"] = collective_trace(one)
        else:
            one()
        rec["peak_gib"] = _peak_gib(card)
        if not (math.isfinite(rec["loss"]) and math.isfinite(
                rec["grad_norm"])):
            raise AssertionError(f"{what} step {i + 1}: {rec}")
        if checks is not None:
            rec["checks"] = checks(state)
        out.append(rec)
    return out


def grad_apply_step(fns, place=None):
    """``tp_train_run``'s step from (grad_fn, apply_fn, zeros_fn): one
    micro-batch a step; ``place`` moves the batch first (one device)."""
    grad_fn, apply_fn, zeros_fn = fns

    def step(state, batch):
        b = batch if place is None else place(batch)
        acc, metrics = grad_fn(state.params, b, zeros_fn(state.params))
        state, norm = apply_fn(state, acc, 1.0)
        del acc
        return state, metrics["loss"], norm

    return step


def clone_state(state):
    c = lambda t: t.clone()                              # noqa: E731
    o = state.opt_state
    return ts.TrainState(opt.tree_map(c, state.params), opt.AdamWState(
        o.count, opt.tree_map(c, o.mu), opt.tree_map(c, o.nu)), state.step)


def tp_train_mesh(shape):
    from block_transformer_tpu_torch.parallel import sharding
    if isinstance(shape, tuple):
        return sharding.named_mesh(*shape, device=CARD)
    return sharding.make_mesh(**shape, device=CARD)


def zero_moment_bytes(state, spec, full_numel: dict) -> dict:
    """{leaf: (this rank's moment bytes, the full moment's)} of the moments
    (mu) whose spec splits a replicated parameter (ZeRO); ``full_numel``
    the full leaves' sizes."""
    pspecs = dict(opt.tree_items(spec.params))
    mspecs = dict(opt.tree_items(spec.opt_state.mu))
    return {"/".join(path): (m.numel() * m.element_size(),
                             full_numel[path] * m.element_size())
            for path, m in opt.tree_items(state.opt_state.mu)
            if ts._spec_axes(mspecs[path])
            and not ts._spec_axes(pspecs[path])}


def tp_trainer_kwargs(out: str, **kw) -> dict:
    return dict(output_dir=out, learning_rate=1e-4, num_train_steps=10,
                stop_steps=2, num_warmup_steps=1, total_batch_size=4,
                micro_batch_size=2, max_length=TRAIN_TOKENS, save_steps=2,
                logging_steps=1, param_dtype="bfloat16", remat=True, **kw)


def tp_trainer_dataset(cfg):
    from block_transformer_tpu_torch.pretrain_block_transformer import (
        synthetic_corpus)
    return packing.PackedDataset(
        synthetic_corpus(SYNTHETIC_TOKENS, cfg.vocab_size, 512),
        TRAIN_TOKENS, eos_token=0, pad_token=0, block_length=cfg.block_length)


def tp_train_rank(rank: int, store: str, out: str, card: str, cfg) -> None:
    """Rank ``rank`` of (b) and (c): two processes on the one card, gloo
    with CUDA tensors. Probes gloo's all-gather (bf16, float32) and its
    all-reduce rate on multi-GB tensors; then each of TP_TRAIN_SHAPES from
    the same bf16 initial state as (a) (seed 0): two steps on
    ``tp_train_batches`` (the second traced), with the checks (a) cannot
    make alone; then (c): the Trainer over (data 2) at TP_TRAINER_LAYERS a
    stack, two steps, its checkpoint at step 2, and the checksums of the
    full state this rank gathers at the end. Saves what it found to
    ``out``."""
    import torch.distributed as dist
    from block_transformer_tpu_torch.parallel import pipeline
    if card == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=2)
    res = {"shapes": {}}
    try:
        coll = {}
        for dt in ("bfloat16", "float32"):
            t = torch.arange(4, device=card).to(getattr(torch, dt)) + rank
            parts = [torch.empty_like(t) for _ in range(2)]
            dist.all_gather(parts, t)
            coll[f"all_gather {dt}"] = bool(torch.equal(
                parts[1] - parts[0], torch.ones_like(t)))
        res["collectives"] = coll
        if not all(coll.values()):
            raise AssertionError(f"gloo on {card} tensors: {coll}")
        rate = {}
        for gib in GLOO_RATE_GIB:
            t = torch.ones(gib * 2**28, dtype=torch.float32, device=card)
            _sync(card)
            t0 = time.perf_counter()
            dist.all_reduce(t)
            _sync(card)
            secs = time.perf_counter() - t0
            ok = bool((t == 2).all())
            rate[f"{gib} GiB"] = {"s": secs, "GB/s": t.numel() * 4 / secs
                                  / 1e9, "ok": ok}
            del t
            if not ok:
                raise AssertionError("gloo all-reduce of a float32 tensor")
        res["gloo_all_reduce"] = rate

        tx, _ = opt.make_optimizer(**TP_TRAIN_LR)
        batches = tp_train_batches(cfg)
        before = launch_counts()
        for name, shape in TP_TRAIN_SHAPES.items():
            t0 = time.perf_counter()
            mesh = tp_train_mesh(shape)
            full = ts.create_train_state(0, cfg, tx, dtype=torch.bfloat16,
                                         device=card)
            if name.startswith("pipe"):
                pp_step, spec = pipeline.make_pp_train_step(
                    mesh, cfg, tx, full.params, n_micro=TP_TRAIN_MICRO,
                    remat=True)

                def step(state, batch):
                    state, m = pp_step(state, batch)
                    return state, m["loss"], m["grad_norm"]
            else:
                spec = ts._state_spec(mesh, full.params)
                step = grad_apply_step(ts.make_sharded_grad_and_apply(
                    mesh, cfg, tx, full.params, remat=True))
            numel = {p: t.numel() for p, t in opt.tree_items(full.params)}
            state = ts.shard_with(mesh, full, spec)
            del full
            if card == "cuda":
                torch.cuda.empty_cache()
            setup = time.perf_counter() - t0
            steps = tp_train_run(
                card, state, step, batches, name, trace=True,
                checks=(lambda st: leaf_checksums(st.params))
                if name.startswith("data") else None)
            res["shapes"][name] = {
                "setup_s": setup, "steps": steps,
                "zero_moment_bytes": zero_moment_bytes(state, spec, numel),
                "param_bytes": sum(p.numel() * p.element_size()
                                   for p in opt.tree_leaves(state.params))}
            del state, step
            if card == "cuda":
                torch.cuda.empty_cache()
        res["launches"] = {t: n - before[t] for t, n in
                           launch_counts().items() if n != before[t]}

        # (c) the Trainer over (data 2), two steps, its checkpoint
        t0 = time.perf_counter()
        small = cut_depth(cfg, TP_TRAINER_LAYERS)
        tr = trainer_lib.Trainer(
            small, trainer_lib.TrainerConfig(**tp_trainer_kwargs(
                os.path.join(TP_TRAIN_DIR, "trainer"), n_data=2)),
            tp_trainer_dataset(small), device=card)
        tr.train()
        full = tr.mesh_state.full(tr.state)
        res["trainer"] = {"s": time.perf_counter() - t0,
                          "checkpoint_log": tr.checkpoint_log,
                          "state": leaf_checksums(full.params),
                          "mu": leaf_checksums(full.opt_state.mu),
                          "nu": leaf_checksums(full.opt_state.nu),
                          "count": full.opt_state.count,
                          "step": full.step}
        del tr, full
        torch.save(res, out)
    finally:
        dist.destroy_process_group()


def phase_tp_train(smi: str, cfg=None) -> None:
    """Training over a mesh with ``cfg`` (``MODEL`` by default; ``main``
    gives it at full width and TP_TRAIN_LAYERS a stack), bf16 parameters
    from seed 0, TP_TRAIN_SEQS x TRAIN_TOKENS tokens a step, remat). (a) One
    rank in this process, NCCL, mesh (data 1, model 1): two steps of
    ``make_sharded_grad_and_apply`` against ``make_grad_and_apply`` on the
    same parameters and batches: the loss, the grad norm and the checksums
    of the parameters and moments equal bit for bit after each step. (b)
    Two ranks on the one card (NCCL refuses two ranks on one device: gloo
    on CUDA tensors), each shape of TP_TRAIN_SHAPES for two steps: each
    step's loss and grad norm within TP_TRAIN_RTOL of (a)'s (one batch at
    both steps: step 2 reads step 1's update), the data ranks' parameters
    equal bit for bit after each step, each rank holding half of a
    ZeRO-split moment. (c)
    The Trainer on the two ranks, ``n_data=2``, TP_TRAINER_LAYERS a stack:
    its step-2 checkpoint restores into the one-device Trainer bit for bit
    (against the full state the other rank gathered) and trains on. No
    hand kernel launches (training runs the plain paths)."""
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from block_transformer_tpu_torch.parallel import sharding
    cfg = config.get_config(MODEL) if cfg is None else cfg
    t_phase = time.perf_counter()
    shutil.rmtree(TP_TRAIN_DIR, ignore_errors=True)
    os.makedirs(TP_TRAIN_DIR)
    tx, _ = opt.make_optimizer(**TP_TRAIN_LR)
    batches = tp_train_batches(cfg)
    tokens = TP_TRAIN_SEQS * TRAIN_TOKENS
    before = launch_counts()
    # (a) the one-device step, then the sharded one on the same state
    full = ts.create_train_state(0, cfg, tx, dtype=torch.bfloat16,
                                 device=CARD)
    one = tp_train_run(CARD, clone_state(full), grad_apply_step(
        ts.make_grad_and_apply(ts.make_loss_fn(cfg, remat=True), tx),
        place=lambda b: packing.to_device(b, CARD)), batches, "one device",
        checks=state_checksums)
    if CARD == "cuda":
        torch.cuda.empty_cache()
    dist.init_process_group(TP_BACKEND[CARD], store=dist.FileStore(
        os.path.join(TP_TRAIN_DIR, "store_a"), 1), rank=0, world_size=1)
    try:
        mesh = sharding.make_mesh(1, 1, device=CARD)
        a = tp_train_run(CARD, ts.shard_state(mesh, tx, full), grad_apply_step(
            ts.make_sharded_grad_and_apply(mesh, cfg, tx, full.params,
                                           remat=True)), batches,
                         "(a) mesh (data 1, model 1)", checks=state_checksums)
    finally:
        dist.destroy_process_group()
    del full
    if CARD == "cuda":
        torch.cuda.empty_cache()
    assert_no_launch(before, "the mesh train steps (a)")
    differ = []
    for i, (x, y) in enumerate(zip(a, one)):
        differ += [f"step {i + 1} {k}" for k in ("loss", "grad_norm", "checks")
                   if x[k] != y[k]]
        log(f"(a) {MODEL} step {i + 1}, mesh (data 1, model 1) over NCCL / "
            f"one device (bf16, {TP_TRAIN_SEQS} x {TRAIN_TOKENS} tokens, "
            f"remat): {x['s']:.3f} / {y['s']:.3f} s = "
            f"{tokens / x['s']:.1f} / {tokens / y['s']:.1f} tokens/s; peak "
            f"{x['peak_gib']:.2f} / {y['peak_gib']:.2f} GiB; loss "
            f"{x['loss']:.6f} / {y['loss']:.6f}; grad_norm "
            f"{x['grad_norm']:.6f} / {y['grad_norm']:.6f} [{smi}]")
    log(f"(a) against one device, loss, grad norm and the checksums of the "
        f"parameters and moments after each step, bit for bit: "
        f"{differ or 'equal'}")
    if differ:
        raise AssertionError(f"(a): the sharded step differs from one "
                             f"device: {differ}")
    log(f"phase_tp_train (a) {time.perf_counter() - t_phase:.1f} s")

    # (b), (c) on two ranks
    t0 = time.perf_counter()
    outs = [os.path.join(TP_TRAIN_DIR, f"b_{r}.pt") for r in range(2)]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=tp_train_rank, args=(
        r, os.path.join(TP_TRAIN_DIR, "store_b"), outs[r], CARD, cfg))
        for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=900)
    for r, p in enumerate(procs):
        if p.is_alive():
            p.kill()
            p.join()
        if p.exitcode != 0:
            raise AssertionError(f"(b) rank {r} exited {p.exitcode}")
    b = [torch.load(o, weights_only=False) for o in outs]
    log(f"phase_tp_train (b), (c) ranks {time.perf_counter() - t0:.1f} s")
    log(json.dumps({"gloo_cuda_all_gather": b[0]["collectives"],
                    "gloo_cuda_all_reduce_float32": [
                        r["gloo_all_reduce"] for r in b], "card": smi}))
    for r in b:
        if r["launches"]:
            raise AssertionError(f"kernels launched in (b): "
                                 f"{r['launches']}")
    for name in TP_TRAIN_SHAPES:
        worst = dict.fromkeys(TP_TRAIN_RTOL, 0.0)
        for r, res in enumerate(b):
            got = res["shapes"][name]
            for i, st in enumerate(got["steps"]):
                log(f"(b) {name} rank {r} step {i + 1} (gloo, CUDA "
                    f"tensors): {st['s']:.3f} s{' traced' if i else ''}, "
                    f"peak {st['peak_gib']:.2f} GiB, loss {st['loss']:.6f}, "
                    f"grad_norm {st['grad_norm']:.6f}; setup "
                    f"{got['setup_s']:.1f} s, parameters "
                    f"{got['param_bytes']} bytes [{smi}]")
            log(json.dumps({f"(b) {name} rank {r} collectives in step 2":
                            got["steps"][1]["collectives"]}))
            gaps = {(i + 1, k): abs(st[k] - a[i][k]) / abs(a[i][k])
                    for i, st in enumerate(got["steps"]) for k in worst}
            for (_, k), v in gaps.items():
                worst[k] = max(worst[k], v)
            log(f"(b) {name} rank {r} against (a), relative differences: "
                + ", ".join(f"step {i} {k} {v:.3e}"
                            for (i, k), v in gaps.items()))
        log(f"(b) {name}: steps 1 and 2 against (a), largest relative "
            f"differences: " + ", ".join(
                f"{k} {v:.3e} (limit {TP_TRAIN_RTOL[k]})"
                for k, v in worst.items()))
        if any(v > TP_TRAIN_RTOL[k] for k, v in worst.items()):
            raise AssertionError(f"(b) {name} differs from (a)")
        if name.startswith("data"):
            for i in range(2):
                if b[0]["shapes"][name]["steps"][i]["checks"] != \
                        b[1]["shapes"][name]["steps"][i]["checks"]:
                    raise AssertionError(f"(b) {name}: the data ranks' "
                                         f"parameters differ after step "
                                         f"{i + 1}")
            zero = [res["shapes"][name]["zero_moment_bytes"] for res in b]
            log(f"(b) {name}: ZeRO-split moments (mu), a rank's bytes "
                f"against the full moment's: {json.dumps(zero[0])}")
            if not zero[0] or zero[0] != zero[1] or any(
                    2 * here != whole for here, whole in zero[0].values()):
                raise AssertionError(f"(b) {name}: ZeRO moment shards are "
                                     "not half a moment each")
            log(f"(b) {name}: the data ranks' parameters equal bit for bit "
                "after steps 1 and 2")

    # (c) the mesh Trainer's checkpoint into the one-device Trainer
    small = cut_depth(cfg, TP_TRAINER_LAYERS)
    out = os.path.join(TP_TRAIN_DIR, "trainer")
    ds = tp_trainer_dataset(small)
    recs = metrics_records(out)
    finite_records(recs, "(c) mesh trainer")
    tr = trainer_lib.Trainer(small, trainer_lib.TrainerConfig(
        **tp_trainer_kwargs(out)), ds, device=CARD)
    t0 = time.perf_counter()
    restored = tr.mesh_state.restore(out, 2, tr.state)
    secs = time.perf_counter() - t0
    want = b[1]["trainer"]
    got = {"state": leaf_checksums(restored.params),
           "mu": leaf_checksums(restored.opt_state.mu),
           "nu": leaf_checksums(restored.opt_state.nu),
           "count": restored.opt_state.count, "step": restored.step}
    differ = [k for k in got if got[k] != want[k]]
    nbytes = checkpoint_bytes(out, 2)
    depth = (small.block_decoder.num_layers,
             small.token_decoder.neox.num_layers)
    log(f"(c) Trainer over (data 2) on two gloo ranks, {depth[0]} + "
        f"{depth[1]} layers at full width, bf16: steps " + ", ".join(
            f"{r['step']} {r['wall_time_s']:.3f} s loss {r['loss']:.6f}"
            for r in recs) + f"; ranks {want['s']:.1f} s with init and the "
        f"step-2 checkpoint ({nbytes} bytes, save "
        f"{b[0]['trainer']['checkpoint_log'][-1]['s']:.2f} s); restored on "
        f"one device in {secs:.2f} s, against rank 1's gathered state bit "
        f"for bit: {differ or 'equal'} [{smi}]")
    if differ or len(recs) != 2:
        raise AssertionError(f"(c) the mesh checkpoint does not restore on "
                             f"one device: {differ}")
    tr.tcfg.stop_steps = 3
    tr.state = restored
    del restored
    tr.train(resume=True)
    last = metrics_records(out)[-1]
    log(f"(c) one device resumed from the mesh checkpoint: step "
        f"{last['step']} loss {last['loss']:.6f}")
    if last["step"] != 3 or not math.isfinite(last["loss"]):
        raise AssertionError("(c) the one-device resume did not train")
    del tr
    assert_no_launch(before, "phase_tp_train")
    shutil.rmtree(TP_TRAIN_DIR, ignore_errors=True)
    if CARD == "cuda":
        torch.cuda.empty_cache()
    log(f"phase_tp_train total {time.perf_counter() - t_phase:.1f} s")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    started = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    log(f"card: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    # float32 products are compared against each other: keep them in full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase_s, lap_start = {}, [started]

    def lap(name: str) -> None:      # each phase's seconds, for the budget
        now = time.perf_counter()
        phase_s[name], lap_start[0] = now - lap_start[0], now

    t0 = time.perf_counter()
    took = build.build_all(["dequant_matmul", "decode_attention",
                            "flash_attention", "paged_attention", "w8a8"])
    log(f"kernel build {time.perf_counter() - t0:.1f} s "
        f"({', '.join(f'{k} {v:.1f} s' for k, v in took.items())})")
    for name, text in build.build_logs.items():
        entry = ""
        for line in text.splitlines():
            if "Compiling entry function" in line:
                entry = kernel_label(line)
            elif "registers" in line or "spill" in line:
                log(f"  ptxas {name} {entry}: {line.strip()}")

    lap("build")
    cfg = config.get_config(MODEL)
    vcfg = config.get_vanilla_config(VANILLA_MODEL)
    rows = []
    phase_k1(rows, cfg)
    phase_k2(rows, cfg, vcfg)
    phase_k2_bf16(rows, cfg)
    phase_k3(rows, cfg, vcfg)
    phase_k4(rows, cfg)
    phase_w8a8(rows, cfg, vcfg, smi)
    phase_k5(rows, cfg)
    phase_k6(rows, cfg)
    phase_k6(rows, cfg, int4=True)
    phase_k7(rows, cfg)
    phase_k8(rows, cfg)
    phase_k8(rows, cfg, int4=True)
    phase_family_kernels(rows)
    phase_bench_kernels(rows, cfg, vcfg)
    floor = launch_floor_ms()
    log(json.dumps({"launch_floor_ms": floor, "card": smi}))
    lap("kernel rows")
    phase_small_reference()
    phase_small_quantized()
    phase_small_engine()
    phase_small_w8a8()
    phase_small_train_gptq()
    phase_small_families()
    lap("small checks")
    launches, tok_s, tokens = {}, {}, {}
    for quantize in ("int8", "int4", "mixed48"):
        t0 = time.perf_counter()
        cfg, params = pg.main_path_model(seed=0, quantize=quantize)
        torch.cuda.synchronize()
        log(f"{MODEL}: random init + {quantize} quantization on the card "
            f"{time.perf_counter() - t0:.2f} s")
        kvs = ("int8", "bf16", "int4") if quantize == "int8" else ("int8",)
        for kv in kvs:
            launches[generation_path(quantize, kv)], tok_s[(quantize, kv)] = (
                phase_generation(cfg, params, quantize, kv))
        if quantize == "int8":
            launches["generation streaming"], _ = phase_generation(
                cfg, params, quantize, "int8", fresh=False)
            for kind in pg.ENGINE_KINDS:
                launches[f"engine {kind}"], tokens[kind] = phase_engine(
                    kind, cfg, params)
            phase_cache_agreement(cfg, params)
        del params
    for a, b in (("int8", "paged"), ("int4", "paged-int4")):
        log_agreement(a, b, tokens[a], tokens[b])
    vcfg, vparams = pg.vanilla_model(seed=0, quantize="int8")
    launches["vanilla"], tok_s["vanilla"] = phase_vanilla(vcfg, vparams)
    del vparams
    log(json.dumps({"device_launches_per_run": device_launches,
                    "card": smi}))
    lap("generation, engines, vanilla")
    launches.update(phase_tp(rows, smi))
    lap("tp")
    phase_tp_train(smi, cut_depth(config.get_config(MODEL), TP_TRAIN_LAYERS))
    lap("tp_train")
    launches.update(phase_families(smi))
    lap("families")
    phase_train_quantize(config.get_config(MODEL))
    lap("train_quantize")
    phase_trainer(smi)
    lap("trainer")
    launches.update(phase_eval(rows, smi))
    lap("eval")
    launches.update(phase_quality(rows, smi))
    lap("quality")
    launches.update(phase_scripts(smi))
    lap("scripts")
    launches.update(phase_probes(smi))
    lap("probes")
    launches.update(phase_bench(smi))
    lap("bench")
    log("block/vanilla generated tokens per second at B=8 p2048/d128, "
        "INT8 KV (smoke figures, not a benchmark): " + ", ".join(
            f"{q} {tok_s[(q, 'int8')] / tok_s['vanilla']:.3f}"
            for q in ("int8", "int4", "mixed48")))
    for row in rows:
        tag = row.pop("tag")
        row["launches"] = launches[row["path"]][tag]
        if tag == "K2 bf16":   # the launches of the row's own route
            row["route_launches"] = launches[row["path"]][
                f"K2 bf16 {row['decode_route']}"]
    log(f"timing windows timed again behind a longer spin: {len(retimed)} "
        f"({sum(retimed):.1f} s of host time at first)")
    log(json.dumps({"phase_s": phase_s, "card": smi}))
    log(f"chip_smoke.py total {time.perf_counter() - started:.1f} s")
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
