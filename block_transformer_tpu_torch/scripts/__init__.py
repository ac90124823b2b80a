"""The quantization-quality scripts of the port (counterparts of the JAX
package's ``scripts/``, one module each under the same file name and
public names): the byte corpus, the quality pipeline (train, held-out
perplexity, harness tasks, decode agreement), the uniform decode gate and
its seed summary, the GPTQ and QAT ladders, and the KV, long-context and
real-task evaluations. Each ``main(argv=None)`` returns its report dict and
runs on the card unless ``--cpu`` is given:

    python -m block_transformer_tpu_torch.scripts.<name> [--cpu] ...

The scripts the JAX package keeps at its top level (``pretrain_*``,
``eval_zero_shot_task``, ``eval_longctx``, ``export_checkpoint``) are the
port's top-level modules.
"""
