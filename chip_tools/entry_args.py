"""The window and softcap arguments of K1's and K4's C entries, for the
probes that call several versions of a source through ctypes.

``fatt_decode`` takes ``int window, float softcap`` and ``fatt_flash_fwd``
``int window_left, int window_right, float softcap2`` just before the
stream; earlier versions take neither.  Later versions of
``fatt_flash_fwd`` also take a bias (its pointer and four strides) and
dropout (flag, seed, threshold, keep_div) after the softcap, and later
still the ALiBi slopes, return_softmax's two buffers and the
clamped_verify flags after those, and then ``window_idx`` (the window on
the indices of segment ids without positions).  ``bind`` sets an entry's
argument types from the older list and returns a callable that takes
that older list, passing no window, no softcap, no bias, no dropout,
none of the later four and ``window_idx`` 0 where the source has them.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

I, F = ctypes.c_int, ctypes.c_float
P, L, U = ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint32
# entry -> (argument types, the values for no window and no softcap)
WINDOW_ARGS = {"fatt_decode": ([I, F], (0, 0.0)),
               "fatt_flash_fwd": ([I, I, F], (-1, -1, 0.0))}
# fatt_flash_fwd's bias and dropout arguments and their values for none
EXTRA_ARGS = ([P, L, L, L, L, I, U, U, F], (None, 0, 0, 0, 0, 0, 0, 0, 1.0))
# fatt_flash_fwd's ALiBi, return_softmax and clamped_verify pointers, null
SURFACE_ARGS = ([P, P, P, P], (None,) * 4)


def _decl(src: Path, entry: str = "fatt_flash_fwd") -> str:
    """The parameter list of C entry ``entry`` in ``src``."""
    text = src.read_text()
    head = text[text.index(f'extern "C" int {entry}('):]
    return head[:head.index(")")]


def takes_surface(src: Path) -> bool:
    """Whether ``fatt_flash_fwd`` of ``src`` takes the ALiBi slopes,
    return_softmax's buffers and the clamped_verify flags."""
    return "alibi2" in _decl(src)


def takes_window_idx(src: Path, entry: str = "fatt_flash_fwd") -> bool:
    """Whether C entry ``entry`` of ``src`` takes ``window_idx``."""
    return "window_idx" in _decl(src, entry)


def takes_window(src: Path, entry: str) -> bool:
    """Whether the C entry point ``entry`` of ``src`` takes a window."""
    return "window" in _decl(src, entry)


def bind(fn, src: Path, entry: str, argtypes):
    """``fn`` (entry ``entry`` of a library built from ``src``) with its
    argument types set; when the source takes a window, a callable over
    the older argument list (``argtypes``, stream last) that passes none,
    with ``.raw`` a callable over the list with the window arguments and,
    where the source takes it, the keyword ``window_idx`` (default 0)."""
    fn.restype = ctypes.c_int
    if entry not in WINDOW_ARGS or not takes_window(src, entry):
        fn.argtypes = argtypes
        return fn
    types, extra = WINDOW_ARGS[entry]
    decl = _decl(src, entry)
    more_types, more = EXTRA_ARGS if "keep_div" in decl else ([], ())
    if "alibi2" in decl:
        more_types, more = more_types + SURFACE_ARGS[0], more + SURFACE_ARGS[1]
    idx = "window_idx" in decl
    fn.argtypes = argtypes[:-1] + types + more_types + [I] * idx + argtypes[-1:]

    def call(*args):
        return fn(*args[:-1], *extra, *more, *(0,) * idx, args[-1])

    def raw(*args, window_idx=0):
        return fn(*args[:-1], *more, *(window_idx,) * idx, args[-1])

    call.raw = raw
    call.takes_window_idx = idx
    return call
