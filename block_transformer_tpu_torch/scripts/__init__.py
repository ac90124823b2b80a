"""The scripts of the port (counterparts of the JAX package's
``scripts/``, one module each under the same file name and public names):
the quantization-quality scripts (the byte corpus, the quality pipeline,
the uniform decode gate and its seed summary, the GPTQ and QAT ladders,
the KV, long-context and real-task evaluations), the entry scripts and
offline asset builders, and the speed probes (``kernel_microbench``,
``prefill_profile``, the W8A8 probes, ``int4kv_probe``,
``mixed48_stage_probe``, ``paged_admit_probe``, ``engine_cpu_ratio``).
Each ``main(argv=None)`` returns its report and runs on the card unless
``--cpu`` is given:

    python -m block_transformer_tpu_torch.scripts.<name> [--cpu] ...

The scripts the JAX package keeps at its top level (``pretrain_*``,
``eval_zero_shot_task``, ``eval_longctx``, ``export_checkpoint``) are the
port's top-level modules.
"""
