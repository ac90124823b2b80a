"""block_transformer_tpu_torch: the Block Transformer in PyTorch for NVIDIA
Hopper (H100), ported from the JAX package ``block_transformer_tpu``.

Plain tensor code is PyTorch; the JAX package's Pallas kernels on this
package's main path (batched generation with INT8 weights and an INT8
global KV cache) are hand-written CUDA C++ kernels under ``csrc/``, built
with ``nvcc`` at first use and bound with ctypes (``kernels/``). Each kernel
module keeps a plain PyTorch version beside its wrapper, which runs it for
tensors on the CPU. Training runs through ``pretrain_block_transformer.py``
and ``pretrain_vanilla_transformer.py`` (the YAML configs, the packed
corpus, ``train/trainer.py``), on the plain PyTorch paths under autograd.
The package imports nothing of the JAX package.
"""

__version__ = "0.1.0"
