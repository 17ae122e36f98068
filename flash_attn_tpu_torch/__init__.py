"""PyTorch + CUDA port of ``flash_attn_tpu`` for NVIDIA Hopper (sm_90a).

Same layout and function names as the JAX package (``ops/``, ``engine/``,
``models/``), PyTorch idiom inside: explicit ``device`` arguments,
``torch.Generator`` for randomness, and in-place KV-cache updates.

Every op that the JAX package runs through a Pallas kernel has two paths
here: a hand-written CUDA kernel (``csrc/``, built with ``nvcc`` at first
use and bound with ``ctypes``) for CUDA tensors, and a plain PyTorch
version of the same arithmetic for CPU tensors.  A CUDA tensor never
reaches the plain version.
"""

from flash_attn_tpu_torch._device import resolve_device
from flash_attn_tpu_torch.ops.decode import flash_decode, flash_decode_chunk

__all__ = ["flash_decode", "flash_decode_chunk", "resolve_device"]
