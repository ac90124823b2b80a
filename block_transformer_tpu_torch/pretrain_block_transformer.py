"""Block-transformer pretraining entry point (port of
``scripts/pretrain_block_transformer.py``, the analogue of the reference's
pretrain_block_transformer.py): load a trainer YAML (the reference schema)
or a named config, build the dataset (Pile idxmaps, the YAML's dataset
stanza, or a synthetic corpus for smoke runs) and run the ``Trainer``.

    python -m block_transformer_tpu_torch.pretrain_block_transformer \\
        --config configs/block_main_b4_5.yaml \\
        --pile /data/pythia_pile_idxmaps/pile_0.87_deduped_text_document
    python -m block_transformer_tpu_torch.pretrain_block_transformer \\
        --model block_main_b4_5 --synthetic 10000 --steps 50 [--cpu]
    python -m block_transformer_tpu_torch.pretrain_block_transformer \\
        --config CONFIG.yaml --from_vanilla VANILLA_DIR \\
        --uptrain_method partition

``--from_vanilla`` reads a GPT-NeoX directory in the HF safetensors layout
(``utils/torch_import.py``) named after its vanilla config (``vanilla_31``
... ``vanilla_410``), seeds the block transformer from it
(``train/uptrain.py``) and starts a fresh optimizer state. The config's
embedder must take the vanilla embedding table (a ``projection_layer``
embedder of the vanilla width): a ``concat`` embedder is narrower.

It trains on the card unless ``--cpu`` is given.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from block_transformer_tpu_torch.data.packing import (PackedDataset,
                                                      TokenizedCorpus)


def synthetic_corpus(n_tokens: int, vocab: int, max_doc: int
                     ) -> TokenizedCorpus:
    """Random documents of 32 to ``max_doc`` - 1 tokens from ids 1 ..
    vocab - 51, ``max(n_tokens // 200, 16)`` of them, from numpy seed 0 (the
    JAX scripts' synthetic corpus)."""
    rng = np.random.default_rng(0)
    docs = [rng.integers(1, vocab - 50, size=rng.integers(32, max_doc))
            for _ in range(max(n_tokens // 200, 16))]
    lengths = np.array([len(d) for d in docs], np.int64)
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    return TokenizedCorpus(np.concatenate(docs), lengths, starts)


def build_dataset(args, block_length: int, max_length: int, vocab: int,
                  yaml_dict=None) -> PackedDataset:
    if args.pile:
        from block_transformer_tpu_torch.data import dispatch
        corpus = dispatch.load_corpus(args.pile)
    elif yaml_dict is not None and yaml_dict.get("dataset") and \
            not args.synthetic:
        # config-driven dispatch (dataset: pythia_pile / t5_pile / hf name)
        from block_transformer_tpu_torch.data import dispatch
        corpus = dispatch.load_corpus_from_yaml(yaml_dict)
    else:
        corpus = synthetic_corpus(args.synthetic, vocab, 512)
    return PackedDataset(corpus, max_length, eos_token=0, pad_token=0,
                         block_length=block_length,
                         random_pad_first_block=not args.no_random_pad,
                         pad_to_block_boundary=True, seed=args.seed)


def main(argv=None):
    """Parse ``argv`` (default: the command line), train, and return the
    ``Trainer``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=None, help="reference-style YAML")
    ap.add_argument("--model", default=None, help="named config (block_main_*)")
    ap.add_argument("--pile", default=None,
                    help="Megatron .bin/.idx prefix (pythia pile idxmaps)")
    ap.add_argument("--synthetic", type=int, default=0,
                    help="use a synthetic corpus of ~N tokens")
    ap.add_argument("--steps", type=int, default=None, help="override stop_steps")
    ap.add_argument("--max_length", type=int, default=None)
    ap.add_argument("--batch_size", type=int, default=None,
                    help="override total_batch_size")
    ap.add_argument("--output_dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--no_random_pad", action="store_true")
    ap.add_argument("--from_vanilla", default=None,
                    help="vanilla checkpoint dir (HF safetensors) for "
                         "uptraining init")
    ap.add_argument("--uptrain_method", default="partition",
                    choices=["skip", "partition", "duplicate"])
    ap.add_argument("--cpu", action="store_true",
                    help="train on the CPU instead of the card")
    args = ap.parse_args(argv)

    from block_transformer_tpu_torch.config import (get_config,
                                                    get_vanilla_config)
    from block_transformer_tpu_torch.train.trainer import (Trainer,
                                                           TrainerConfig)

    yaml_dict = None
    if args.config:
        from block_transformer_tpu_torch import config_yaml
        yaml_dict = config_yaml.read_yaml(args.config)
        cfg = config_yaml.load_block_config_yaml(args.config)
        tkw = config_yaml.load_trainer_kwargs_yaml(args.config)
    elif args.model:
        cfg = get_config(args.model)
        tkw = {"output_dir": f"results/{args.model}"}
    else:
        ap.error("one of --config / --model is required")
    if args.steps:
        tkw["stop_steps"] = args.steps
        tkw["num_train_steps"] = max(args.steps,
                                     tkw.get("num_train_steps", args.steps))
    if args.output_dir:
        tkw["output_dir"] = args.output_dir
    if args.max_length:
        tkw["max_length"] = args.max_length
    if args.batch_size:
        tkw["total_batch_size"] = args.batch_size
        tkw.pop("micro_batch_size", None)
    tcfg = TrainerConfig(**tkw)

    ds = build_dataset(args, cfg.block_length, tcfg.max_length,
                       cfg.vocab_size, yaml_dict=yaml_dict)
    trainer = Trainer(cfg, tcfg, ds, device="cpu" if args.cpu else "cuda")

    if args.from_vanilla:
        from block_transformer_tpu_torch.train import train_step as ts
        from block_transformer_tpu_torch.train import uptrain
        from block_transformer_tpu_torch.utils import torch_import
        van_cfg = get_vanilla_config(
            os.path.basename(os.path.normpath(args.from_vanilla)))
        sd = torch_import._load_safetensors_dir(args.from_vanilla)
        vp = torch_import.neox_params_from_state_dict(sd, van_cfg,
                                                      device=trainer.device)
        new_params = uptrain.load_block_from_vanilla(
            trainer.state.params, cfg, vp, van_cfg, method=args.uptrain_method)
        trainer.state = ts.TrainState(new_params, trainer.tx.init(new_params),
                                      trainer.state.step)

    state = trainer.train(resume=args.resume)
    print(f"finished at step {state.step}; checkpoints in {tcfg.output_dir}")
    return trainer


if __name__ == "__main__":
    main()
