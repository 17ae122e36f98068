"""Pipeline parallelism: the GPipe fill-drain ring over a mesh axis.

Port of flash_attn_tpu/parallel/pp.py in the mesh's single-process form.
Every rank holds one stage's params; at each of the num_microbatches +
n - 1 ticks every rank applies its stage to what it holds (rank 0 takes
the next microbatch while any is left), the last rank records its output
for microbatch t - (n - 1), and the activations move one rank along the
ring (``mesh.ppermute``).  The outputs are broadcast from the last rank
by a ``psum`` of zeros elsewhere, as JAX does.  Plain torch, as JAX's is
plain jnp: the stages run whatever kernels their functions call.
"""

from __future__ import annotations

from typing import Sequence

import torch

from flash_attn_tpu_torch.parallel.mesh import ppermute, psum, shard_views


def split_layers(params_blocks: Sequence, num_stages: int) -> list:
    """Partition a list of per-layer params into contiguous stages."""
    n = len(params_blocks)
    per = -(-n // num_stages)
    return [params_blocks[i * per:(i + 1) * per] for i in range(num_stages)]


def pipeline_spmd(stage_fn, params_stacked, x, *, mesh, axis_name: str,
                  num_microbatches: int) -> torch.Tensor:
    """stage_fn(stage_params, h) -> h.

    params_stacked: one stage's params a rank of ``axis_name``, as a list
    in rank order, or a tensor stacked on its leading axis (split over the
    ranks, each rank's slice keeping that axis, as JAX's shard does);
    x: the input microbatches [num_microbatches, mb, ...] (rank 0's).
    Returns the outputs [num_microbatches, mb, ...] on rank 0's device
    (every rank's are the same)."""
    devs = mesh.axis_devices(axis_name)
    n = len(devs)
    if isinstance(params_stacked, torch.Tensor):
        spec = (axis_name,) + (None,) * (params_stacked.ndim - 1)
        params_stacked = shard_views(mesh, params_stacked, spec)
    if len(params_stacked) != n:
        raise ValueError(f"{len(params_stacked)} stages for {n} ranks of {axis_name!r}")
    mb_shape = x.shape[1:]
    h = [torch.zeros(mb_shape, dtype=x.dtype, device=d) for d in devs]
    outputs = torch.zeros((num_microbatches,) + mb_shape, dtype=x.dtype, device=devs[-1])
    for t in range(num_microbatches + n - 1):
        h_out = []
        for r in range(n):
            inp = x[t].to(devs[r]) if r == 0 and t < num_microbatches else h[r]
            h_out.append(stage_fn(params_stacked[r], inp))
        if t >= n - 1:  # the last stage's output of microbatch t - (n - 1)
            outputs[t - (n - 1)] = h_out[-1]
        h = ppermute(mesh, h_out, axis_name)
    held = [outputs if r == n - 1 else torch.zeros_like(outputs, device=d)
            for r, d in enumerate(devs)]
    return psum(mesh, held, axis_name)[0]
