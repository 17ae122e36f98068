"""ctypes binding to the port's native page allocator
(``runtime/native/page_allocator.cc``), which the paged engine's
admission uses.

Port of the ``PagePool`` half of flash_attn_tpu/runtime/abi.py; the C ABI
attention entry points are not ported yet.  The allocator is host code:
at first use it is built with the host C++ compiler (``c++``, or
``$CXX``) into ``flash_attn_tpu_torch/_build/<hash of the source>/``,
the same on the CPU as beside the card.  A missing compiler or a failed
build raises: there is no Python stand-in.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from ctypes import POINTER, c_int32, c_void_p
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
_SRC = Path(__file__).resolve().parent / "native" / "page_allocator.cc"
_FLAGS = ["-std=c++17", "-O2", "-shared", "-fPIC"]


def _compiler() -> str:
    cxx = os.environ.get("CXX") or shutil.which("c++")
    if not cxx:
        raise RuntimeError("no host C++ compiler (c++): the page allocator cannot be built")
    return cxx


@functools.cache
def load() -> ctypes.CDLL:
    """The loaded allocator library, built first if its source changed."""
    h = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode()).hexdigest()[:16]
    out_dir = _PKG / "_build" / f"host-{h}"
    path = out_dir / "libpagealloc.so"
    if not path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"libpagealloc.so.tmp{os.getpid()}"
        res = subprocess.run([_compiler(), *_FLAGS, "-o", str(tmp), str(_SRC)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError("page allocator build failed:\n" + res.stdout + res.stderr)
        os.replace(tmp, path)
    lib = ctypes.CDLL(str(path))
    i32p = POINTER(c_int32)
    for name, res_t, args in (
            ("fatt_pool_create", c_void_p, [c_int32]),
            ("fatt_pool_destroy", None, [c_void_p]),
            ("fatt_pool_free_count", c_int32, [c_void_p]),
            ("fatt_pool_acquire", c_int32, [c_void_p, c_int32, c_int32, i32p]),
            ("fatt_pool_release_slot", c_int32, [c_void_p, c_int32]),
            ("fatt_pool_owner", c_int32, [c_void_p, c_int32]),
            ("fatt_pool_transfer", c_int32, [c_void_p, i32p, c_int32, c_int32]),
            ("fatt_pool_release_pages", c_int32, [c_void_p, i32p, c_int32])):
        fn = getattr(lib, name)
        fn.restype = res_t
        fn.argtypes = args
    return lib


class PagePool:
    """Python wrapper over the native page allocator."""

    def __init__(self, num_pages: int):
        self._lib = load()
        self._pool = self._lib.fatt_pool_create(num_pages)
        if not self._pool:
            raise ValueError(f"could not create pool with {num_pages} pages")

    def acquire(self, slot: int, n: int) -> list[int] | None:
        """``n`` pages for ``slot``, or None (and nothing taken) if the
        pool has fewer free."""
        out = (c_int32 * n)()
        got = self._lib.fatt_pool_acquire(self._pool, slot, n, out)
        if got < 0:
            return None
        return list(out[:got])

    def release_slot(self, slot: int) -> int:
        return self._lib.fatt_pool_release_slot(self._pool, slot)

    @property
    def free_count(self) -> int:
        return self._lib.fatt_pool_free_count(self._pool)

    def owner(self, page: int) -> int:
        return self._lib.fatt_pool_owner(self._pool, page)

    def transfer(self, pages, new_slot: int) -> int:
        """Move ownership of specific pages to ``new_slot`` (prefix-cache
        donation); returns the number transferred."""
        arr = (c_int32 * len(pages))(*pages)
        return self._lib.fatt_pool_transfer(self._pool, arr, len(pages), new_slot)

    def release_pages(self, pages) -> int:
        """Free specific pages (prefix-cache eviction); idempotent."""
        arr = (c_int32 * len(pages))(*pages)
        return self._lib.fatt_pool_release_pages(self._pool, arr, len(pages))

    def __del__(self):
        if getattr(self, "_pool", None):
            self._lib.fatt_pool_destroy(self._pool)
            self._pool = None
