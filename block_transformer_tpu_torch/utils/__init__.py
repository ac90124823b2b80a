"""Utilities: train-state checkpoints, the HF safetensors layout (import,
export and the file format), the device-memory and roofline models, and
profiling."""
