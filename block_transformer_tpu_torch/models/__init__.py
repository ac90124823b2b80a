"""Model components: GPT-NeoX stack, embedder, block and token decoders."""
