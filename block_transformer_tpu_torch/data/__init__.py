"""Data layout: token arrays into block-format training batches."""
