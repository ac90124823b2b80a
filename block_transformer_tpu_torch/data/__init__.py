"""Data: corpora, packing, block splitting and block-format training
batches."""
