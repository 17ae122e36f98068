"""The port's device mesh and the collectives its parallel paths use.

Port of flash_attn_tpu/parallel/mesh.py:25-52 (``MeshConfig``,
``make_mesh``, ``shard``, ``host_local_mesh``) in the single-process form
that ``shard_map`` takes over a host-local mesh: a ``(dp, tp, sp)`` grid
of ``torch.device``s under JAX's axis names, one process driving every
rank.  A rank's shard is a tensor on its device, and a collective is a
reshuffle of the ranks' list: ``ppermute`` moves each rank's tensor to
the next rank's device (no copy where they share a device, as the ranks
of one card do), ``all_to_all`` regroups a split axis.  The ranks of one
card are logical ranks, as JAX's tests put them on virtual CPU devices.
A multi-process (NCCL) form is not ported.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

DATA_AXIS = "dp"
TENSOR_AXIS = "tp"
SEQUENCE_AXIS = "sp"
EXPERT_AXIS = "ep"
AXES = (DATA_AXIS, TENSOR_AXIS, SEQUENCE_AXIS)


@dataclass(frozen=True)
class MeshConfig:
    dp: int = 1
    tp: int = 1
    sp: int = 1

    @property
    def size(self):
        return self.dp * self.tp * self.sp


@dataclass(frozen=True)
class Mesh:
    """``devices[i][j][k]`` is the rank at (dp=i, tp=j, sp=k)."""

    devices: tuple
    axis_names: tuple = AXES

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: len(self.devices), TENSOR_AXIS: len(self.devices[0]),
                SEQUENCE_AXIS: len(self.devices[0][0])}

    def axis_devices(self, axis: str) -> list:
        """The devices along ``axis`` at index 0 of the other two.  The
        other axes hold replicas of the same computation under a spec that
        names ``axis`` alone, so one process computes it once."""
        if axis not in self.axis_names:
            raise ValueError(f"unknown mesh axis {axis!r}; the axes are {self.axis_names}")
        i = self.axis_names.index(axis)
        n = self.shape[axis]
        return [self.devices[r if i == 0 else 0][r if i == 1 else 0][r if i == 2 else 0]
                for r in range(n)]


def make_mesh(cfg: MeshConfig | None = None, devices=None) -> Mesh:
    """A mesh over ``devices`` (default: every CUDA device), raising when
    ``cfg`` needs more of them than there are.  Devices may repeat: ranks
    on one device share it."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if cfg is None:
        cfg = MeshConfig(tp=len(devices))
    if cfg.size > len(devices):
        raise ValueError(f"mesh {cfg} needs {cfg.size} devices, have {len(devices)}")
    it = iter(devices[: cfg.size])
    grid = tuple(tuple(tuple(next(it) for _ in range(cfg.sp)) for _ in range(cfg.tp))
                 for _ in range(cfg.dp))
    return Mesh(grid)


def host_local_mesh(n: int = 8, axis: str = TENSOR_AXIS) -> Mesh:
    """Testing helper: ``n`` CPU ranks, all on ``axis`` (the tensor axis
    by default, as JAX's)."""
    return make_mesh(MeshConfig(**{axis: n}), ["cpu"] * n)


def _spec_axis(mesh: Mesh, spec) -> tuple[int, str]:
    named = [(dim, name) for dim, name in enumerate(spec) if name is not None]
    if len(named) != 1 or named[0][1] not in mesh.axis_names:
        raise ValueError(f"spec {spec} must name one mesh axis of {mesh.axis_names}")
    return named[0]


def shard(mesh: Mesh, x: torch.Tensor, spec) -> list:
    """Split ``x`` along the dimension that ``spec`` (one entry a
    dimension: None, or the mesh axis it is split over) names, one
    contiguous shard a rank on the rank's device."""
    dim, axis = _spec_axis(mesh, spec)
    devs = mesh.axis_devices(axis)
    if len(spec) != x.ndim or x.shape[dim] % len(devs):
        raise ValueError(f"cannot split {tuple(x.shape)} by {spec} over {len(devs)} ranks")
    return [p.to(d).contiguous() for p, d in zip(torch.chunk(x, len(devs), dim), devs)]


def unshard(mesh: Mesh, xs: list, spec, device=None) -> torch.Tensor:
    """The inverse of ``shard``: the ranks' shards joined on ``device``
    (rank 0's by default)."""
    dim, _ = _spec_axis(mesh, spec)
    device = xs[0].device if device is None else device
    return torch.cat([x.to(device) for x in xs], dim=dim)


def ppermute(mesh: Mesh, xs: list, axis: str = SEQUENCE_AXIS) -> list:
    """The ring shift: rank r's tensor goes to rank r + 1 (mod n)."""
    devs = mesh.axis_devices(axis)
    n = len(devs)
    return [xs[(r - 1) % n].to(devs[r]) for r in range(n)]


def all_to_all(mesh: Mesh, xs: list, split_dim: int, concat_dim: int,
               axis: str = SEQUENCE_AXIS) -> list:
    """``jax.lax.all_to_all(tiled=True)``: each rank splits its tensor in
    n along ``split_dim`` and sends part j to rank j, which joins the parts
    in rank order along ``concat_dim``."""
    devs = mesh.axis_devices(axis)
    n = len(devs)
    parts = [torch.chunk(x, n, split_dim) for x in xs]
    return [torch.cat([parts[s][r].to(devs[r]) for s in range(n)], dim=concat_dim)
            for r in range(n)]


def same_device(a, b) -> bool:
    """Whether two devices are one (``cuda`` is the current CUDA device)."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    cur = torch.cuda.current_device() if a.index is None or b.index is None else None
    return (cur if a.index is None else a.index) == (cur if b.index is None else b.index)


def axis_device(mesh: Mesh, axis: str):
    """The one device that every rank of ``axis`` sits on, or None when
    they sit on more than one."""
    devs = mesh.axis_devices(axis)
    return devs[0] if all(same_device(d, devs[0]) for d in devs) else None


def shard_views(mesh: Mesh, x: torch.Tensor, spec) -> list:
    """``shard`` without a copy where the ranks of the spec's axis all sit
    on ``x``'s device: rank r's shard is then a view of ``x`` (not
    contiguous unless the split dimension leads)."""
    dim, axis = _spec_axis(mesh, spec)
    dev = axis_device(mesh, axis)
    if dev is None or not same_device(dev, x.device):
        return shard(mesh, x, spec)
    n = mesh.shape[axis]
    if len(spec) != x.ndim or x.shape[dim] % n:
        raise ValueError(f"cannot split {tuple(x.shape)} by {spec} over {n} ranks")
    return list(torch.chunk(x, n, dim))


def psum(mesh: Mesh, xs: list, axis: str = TENSOR_AXIS) -> list:
    """``jax.lax.psum``: the sum of the ranks' tensors in rank order, on
    every rank's device."""
    devs = mesh.axis_devices(axis)
    total = xs[0]
    for x in xs[1:]:
        total = total + x.to(total.device)
    return [total.to(d) for d in devs]


def pmax(mesh: Mesh, xs: list, axis: str = TENSOR_AXIS) -> list:
    """``jax.lax.pmax``: the elementwise max of the ranks' tensors, on
    every rank's device."""
    devs = mesh.axis_devices(axis)
    out = xs[0]
    for x in xs[1:]:
        out = torch.maximum(out, x.to(out.device))
    return [out.to(d) for d in devs]


def all_gather(mesh: Mesh, xs: list, axis: str = TENSOR_AXIS, dim: int = 0,
               tiled: bool = False) -> list:
    """``jax.lax.all_gather``: the ranks' tensors stacked in rank order
    along a new ``dim`` (joined along ``dim`` when ``tiled``), on every
    rank's device."""
    join = torch.cat if tiled else torch.stack
    out = {}  # one gathered tensor a device
    for d in mesh.axis_devices(axis):
        if str(d) not in out:
            out[str(d)] = join([x.to(d) for x in xs], dim=dim)
    return [out[str(d)] for d in mesh.axis_devices(axis)]
