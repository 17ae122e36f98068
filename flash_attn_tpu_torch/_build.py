"""Build and load the port's CUDA kernels (``csrc/*.cu``) as one shared
library with a plain C interface, bound with ``ctypes``.

The library is built at first use into ``flash_attn_tpu_torch/_build/``
(listed in ``.gitignore``), under a directory named by the hash of the
sources, so an edited source rebuilds.  Each ``.cu`` file compiles in its
own ``nvcc`` process, all started together, then one link step makes the
``.so``.  A failed build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
L = ctypes.c_int64
U = ctypes.c_uint32
# K4's, K9's and K10's bias and dropout arguments: the bias and its four
# strides, the dropout flag, the seed's bits and the keep threshold, and
# f32(1 - rate) (K4) or 1 / (1 - rate) (K9, K10)
_EXTRA = [P, L, L, L, L, I, U, U, F]
# after them, K4 takes the ALiBi slopes, return_softmax's two buffers and
# the clamped_verify flags; K9 the slopes and dS; K10 the slopes

# C entry point -> argument types (every pointer and the stream as c_void_p)
_SIGNATURES = {
    "fatt_decode": [P, P, P, P, P, P, P, P, P,
                    I, I, I, I, I, I, I, I, I, F, F, I, F, I, F, P],
    "fatt_decode_view": [P, P, P, P, P, P, P, P,
                         I, I, I, I, I, I, I, I, I, I, I, F, F, I, F, I, F, P],
    "fatt_chunk_attn": [P, P, P, P, P, P, P, P, P, P,
                        I, I, I, I, I, I, I, I, I, I, F, I, F, P],
    "fatt_kv_append": [P, P, P, P, P, P, P, I, I, I, I, I, P],
    "fatt_empty": [I, I, P],
    "fatt_matmul_float_q": [P, P, P, P, P, I, I, I, I, I, I, I, I, P],
    "fatt_matmul_s8_q": [P, P, P, P, P, P, I, I, I, I, I, I, I, P],
    "fatt_flash_fwd": [P, P, P, P, P, P, P, P, P, P, P, P,
                       I, I, I, I, I, I, I, F, I, I, I, I, F, *_EXTRA, P, P, P, P, P],
    "fatt_paged_decode": [P, P, P, P, P, P, P, P, P, P, P, P,
                          I, I, I, I, I, I, I, I, F, I, F, P],
    "fatt_flash_bwd_dq": [P, P, P, P, P, P, P, P, P, P,
                          I, I, I, I, I, I, I, F, I, I, I, F, P, P, P, P, *_EXTRA, P, P, P],
    "fatt_flash_bwd_dkv": [P, P, P, P, P, P, P, P,
                           I, I, I, I, I, I, F, I, I, I, F, P, P, P, P, *_EXTRA, P, P],
    "fatt_lse_merge": [P, P, P, P, I, L, I, I, P],
    "fatt_ring_attn": [P, P, P, P, P, I, I, I, I, I, I, I, I, F, P, P],
}

# seconds the last build took in this process (0.0 when it was cached)
build_seconds = 0.0


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources():
    return sorted(_CSRC.glob("*.cu")), sorted(_CSRC.glob("*.cuh"))


def _source_hash() -> str:
    cu, cuh = _sources()
    h = hashlib.sha256()
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(_ARCH + _FLAGS).encode())
    return h.hexdigest()[:16]


def _build(out_dir: Path) -> Path:
    global build_seconds
    t0 = time.perf_counter()
    nvcc = nvcc_path()
    cu, _ = _sources()
    tmp = out_dir.with_name(out_dir.name + f".tmp{os.getpid()}")
    tmp.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in cu:
        obj = tmp / (src.stem + ".o")
        cmd = [nvcc, *_ARCH, *_FLAGS, "-I", str(_CSRC), "-c", str(src),
               "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for src, _, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{src.name}:\n{out.decode(errors='replace')}")
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    lib = tmp / "libfatt.so"
    cmd = [nvcc, *_ARCH, "-shared", "-o", str(lib),
           *[str(o) for _, o, _ in procs]]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + res.stdout + res.stderr)
    if out_dir.exists():
        shutil.rmtree(tmp)
    else:
        os.replace(tmp, out_dir)
    build_seconds = time.perf_counter() - t0
    return out_dir / "libfatt.so"


@functools.cache
def lib() -> ctypes.CDLL:
    """The loaded kernel library, built first if its sources changed."""
    out_dir = _BUILD / _source_hash()
    path = out_dir / "libfatt.so"
    if not path.exists():
        path = _build(out_dir)
    so = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(so, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return so


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def check(rc: int, name: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")


def ptr(t) -> int | None:
    return None if t is None else t.data_ptr()
