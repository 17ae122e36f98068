"""Profiling and roofline accounting on the card.

Port of flash_attn_tpu/utils/profiling.py:

- trace(): a ``torch.profiler`` window that exports a Chrome trace (view
  it in Perfetto or chrome://tracing), in place of ``jax.profiler``;
- device_busy(): the union of the device's activity intervals in a
  traced window, and so its idle share;
- Roofline: per-kernel bytes and operations against the card's peaks;
- benchmark(): median wall-clock seconds of a call, synchronized.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

# Per-card peaks: (bf16 TFLOP/s, int8 TOP/s, HBM GB/s), dense, from NVIDIA's
# data sheets; "cpu" is the JAX package's placeholder for CPU runs.
CHIP_PEAKS = {
    "h100-sxm": (989.0, 1979.0, 3350.0),
    "h100-pcie": (756.0, 1513.0, 2000.0),
    "cpu": (0.5, 0.5, 50.0),
}


def chip_kind() -> str:
    """The CHIP_PEAKS key of device 0 ("cpu" without a card).  An unknown
    card raises: silently taking some card's peaks would mis-scale every
    roofline fraction.  Override with FATPU_CHIP if the table lacks it."""
    if not torch.cuda.is_available():
        return "cpu"
    name = torch.cuda.get_device_name(0).lower()
    if "h100" in name:
        if "pcie" in name:
            return "h100-pcie"
        if "hbm3" in name or "sxm" in name:
            return "h100-sxm"
    override = os.environ.get("FATPU_CHIP")
    if override:
        if override not in CHIP_PEAKS:
            raise ValueError(f"FATPU_CHIP={override!r} not in CHIP_PEAKS "
                             f"({sorted(CHIP_PEAKS)})")
        return override
    raise ValueError(f"unrecognized card {name!r}; set FATPU_CHIP to one of "
                     f"{sorted(CHIP_PEAKS)} or add its peaks to CHIP_PEAKS")


@contextlib.contextmanager
def trace(log_dir: str | os.PathLike | None = None, *, host: bool = True):
    """``torch.profiler`` over the block, the card's activity included when
    there is one; yields the profiler.  ``host=False`` records the card's
    activity alone, which costs the host less (without a card the host's
    is recorded all the same).  With ``log_dir`` the Chrome trace is
    written to ``log_dir/trace.json``."""
    cuda = torch.cuda.is_available()
    acts = [torch.profiler.ProfilerActivity.CPU] if host or not cuda else []
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    if log_dir is not None:
        Path(log_dir).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))


def _device_events(prof):
    """The card's activities (kernels, copies, fills), not the spans that
    mark a host range on the device's timeline."""
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and e.time_range.end > e.time_range.start]


def device_busy(prof, window: tuple[float, float] | None = None) -> tuple[float, float]:
    """(busy, window) in microseconds: the union of the device's activity
    intervals (kernels, copies, fills) clipped to ``window`` (default: the
    first to the last of them).  The idle share is 1 - busy / window."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in _device_events(prof))
    if window is None:
        if not spans:
            return 0.0, 0.0
        window = (spans[0][0], max(end for _, end in spans))
    lo, hi = window
    busy, cur_lo, cur_hi = 0.0, None, None
    for s, e in spans:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if cur_hi is None or s > cur_hi:
            if cur_hi is not None:
                busy += cur_hi - cur_lo
            cur_lo, cur_hi = s, e
        else:
            cur_hi = max(cur_hi, e)
    if cur_hi is not None:
        busy += cur_hi - cur_lo
    return busy, hi - lo


def top_kernels(prof, n: int = 5) -> list[tuple[str, float, int]]:
    """The ``n`` device activities with the most time in the window: (name,
    total ms, count)."""
    total: dict[str, list] = {}
    for e in _device_events(prof):
        t = total.setdefault(e.name, [0.0, 0])
        t[0] += (e.time_range.end - e.time_range.start) / 1e3
        t[1] += 1
    ranked = sorted(total.items(), key=lambda kv: -kv[1][0])[:n]
    return [(name, ms, count) for name, (ms, count) in ranked]


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def benchmark(fn, *args, iters: int = 20, warmup: int = 3) -> float:
    """Median wall-clock seconds of fn(*args), the card synchronized after
    each call."""
    for _ in range(warmup):
        fn(*args)
    _sync()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        _sync()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


@dataclass
class Roofline:
    """Operation cost model vs chip peaks."""

    flops: float
    bytes: float
    chip: str = ""

    def __post_init__(self):
        if not self.chip:
            self.chip = chip_kind()

    @property
    def peaks(self):
        return CHIP_PEAKS[self.chip]

    @property
    def ideal_seconds(self) -> float:
        tflops, _, gbs = self.peaks
        return max(self.flops / (tflops * 1e12), self.bytes / (gbs * 1e9))

    @property
    def compute_bound(self) -> bool:
        tflops, _, gbs = self.peaks
        return self.flops / (tflops * 1e12) > self.bytes / (gbs * 1e9)

    def fraction(self, measured_seconds: float) -> float:
        return self.ideal_seconds / measured_seconds

    def report(self, measured_seconds: float) -> dict:
        return {
            "chip": self.chip,
            "bound": "compute" if self.compute_bound else "memory",
            "ideal_us": round(self.ideal_seconds * 1e6, 2),
            "measured_us": round(measured_seconds * 1e6, 2),
            "roofline_frac": round(self.fraction(measured_seconds), 4),
            "tflops": round(self.flops / measured_seconds / 1e12, 2),
            "gbs": round(self.bytes / measured_seconds / 1e9, 2),
        }


def attention_fwd_cost(batch, sq, sk, heads, head_dim, *, causal=False,
                       dtype_bytes=2, kv_heads=None, lse=True):
    """Roofline inputs for the FA2 forward kernel."""
    kv_heads = kv_heads or heads
    pairs = sq * sk * (0.5 if causal else 1.0)
    flops = 4 * batch * heads * pairs * head_dim
    bytes_ = (
        batch * sq * heads * head_dim * dtype_bytes * 2  # q + out
        + batch * sk * kv_heads * head_dim * dtype_bytes * 2  # k + v
        + (batch * heads * sq * 4 if lse else 0)
    )
    return Roofline(flops=flops, bytes=bytes_)


def decode_cost(batch, sk, heads, kv_heads, head_dim, *, kv_bytes=2,
                scale_bytes=0):
    """Decode attention is KV-bandwidth-bound."""
    flops = 4 * batch * heads * sk * head_dim
    bytes_ = 2 * batch * sk * kv_heads * (head_dim * kv_bytes + scale_bytes)
    return Roofline(flops=flops, bytes=bytes_)
