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
from flash_attn_tpu_torch.ops.alibi import alibi_slopes
from flash_attn_tpu_torch.ops.attention import flash_attention, flash_attention_varlen
from flash_attn_tpu_torch.ops.decode import flash_decode, flash_decode_chunk
from flash_attn_tpu_torch.ops.flash_fwd import FlashConfig
from flash_attn_tpu_torch.ops.lse import lse_merge, lse_merge2
from flash_attn_tpu_torch.ops.matmul import (
    W4A8Weight,
    W8A8Weight,
    matmul_int4,
    matmul_int8,
    matmul_w4a8,
    matmul_w8a8,
    quantized_matmul,
)
from flash_attn_tpu_torch.ops.quant import (
    quantize_fp8,
    quantize_int4,
    quantize_int8,
    quantize_kv,
)
from flash_attn_tpu_torch.ops.reference import mha_reference
from flash_attn_tpu_torch.version import __version__

__all__ = [
    "FlashConfig",
    "alibi_slopes",
    "flash_attention",
    "flash_attention_varlen",
    "flash_decode",
    "flash_decode_chunk",
    "lse_merge",
    "lse_merge2",
    "W4A8Weight",
    "W8A8Weight",
    "matmul_int4",
    "matmul_int8",
    "matmul_w4a8",
    "matmul_w8a8",
    "mha_reference",
    "quantize_fp8",
    "quantize_int4",
    "quantize_int8",
    "quantize_kv",
    "quantized_matmul",
    "resolve_device",
    "__version__",
]
