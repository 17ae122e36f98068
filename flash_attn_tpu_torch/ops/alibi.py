"""ALiBi (attention with linear biases) slope table.

Port of flash_attn_tpu/ops/alibi.py: the head-slope schedule of the ALiBi
paper (BLOOM's and MPT's, and upstream flash-attention's
``alibi_slopes``): for ``n`` a power of two, slope_i = 2^(-8 (i+1) / n);
other head counts interleave the schedule of the next power of two.  The
kernels apply ``-slope_h * |i + Sk - Sq - j|`` (bottom-right aligned) to
the scores, causal or not.
"""

from __future__ import annotations

import numpy as np


def alibi_slopes(num_heads: int) -> np.ndarray:
    """[num_heads] fp32 slopes (BLOOM/MPT schedule), numpy as JAX's."""

    def pow2_slopes(n):
        start = 2.0 ** (-(2.0 ** -(np.log2(n) - 3)))
        return start * (start ** np.arange(n))

    if np.log2(num_heads).is_integer():
        s = pow2_slopes(num_heads)
    else:
        closest = 2 ** int(np.floor(np.log2(num_heads)))
        extra = pow2_slopes(2 * closest)[0::2][: num_heads - closest]
        s = np.concatenate([pow2_slopes(closest), extra])
    return s.astype(np.float32)
