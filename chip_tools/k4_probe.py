#!/usr/bin/env python3
"""K4 against other versions of its source: registers, errors and times.

    python3 chip_tools/k4_probe.py [--old NAME=DIR ...] [--require-bitwise]

Each DIR holds a ``flash_fwd.cu`` (and the ``common.cuh`` it includes),
for example an earlier tree's ``flash_attn_tpu_torch/csrc`` or a copy of
this one with a design change to try; every version exports
``fatt_flash_fwd``, with or without the four tile-metadata pointers and
the tile count of segment ids and positions (read from the source's
declaration).  Each, and this tree's
``csrc/flash_fwd.cu``, compiles (``-Xptxas -v``, the flags of
``_build.py``) into its own library under
``flash_attn_tpu_torch/_build/k4_probe/`` and launches through ctypes at
the training and prefill shape (B=1, S=2048, H=32, Hk=8, D=128, causal,
rope) in both softmax modes: the largest output error as a share of its
row's tolerance (2^-6 of the row's largest |ref|, as chip_smoke.py holds
K4), the LSE error, whether output and LSE are bitwise those of the first
version, and the time (CUDA events over 20 launches, after warm-up), in
turns (old..., this, this, ...old reversed).  Versions that take segment
ids and positions are held the same way, clamped, at the packed
prefill's shape (phase 4's eight prompts in 4096) and a chunk's (Sq=512
at start 1024 over 4096, positions alone).  Versions whose entry takes a
window (and a softcap) are also held at LOCAL_CASES: head_dim 256, phase
2's Gemma-2-9B shape (B=1, S=8192, H=16, Hk=8, causal, clamped, softcap
50, scale 1/16, rope), with the sliding window (4095, -1), without, and
without the softcap too (what the softcap costs); GPT-2's head_dim 64
(B=8, S=1024, H=Hk=12, causal, clamped); and, for versions that build
K4's head_dim 128 kLocal instance, Gemma-2-27B's (H=32, Hk=16, scale
1/12, softcap 50) with the window and without: the same errors and
bitwise checks, and the time with its TFLOP/s on the live pairs.  Versions
that build the masked kLocal instance are held at MASKED_LOCAL_CASES too:
Mistral-7B's widths (H=32, Hk=8, D=128, rope theta 1e4, window (4095, -1))
with segment ids and positions, 8 prompts packed in 8192 (the window on
the positions, clamped and with cap 50); versions whose entry takes
``window_idx`` also with segment ids alone (the window on the indices):
the training row's four documents in 8192, causal, online, with and
without cap 50, and a two-sided window (64, 32) not causal over eight
documents in 2048, each against the plain version and bitwise against the
first version that ran it.  Versions
whose entry takes a bias and dropout are also held at EXTRA_CASES, the
kExtra instances (online softmax): the mask alone at phase 18's dense
shape (B=2, S=2048, H=32, Hk=8, D=128, causal, a [2, 1, 2048, 2048] fp32
mask), phase 18's varlen call (8 sequences in 8192 tokens, causal in
each, the [8192, 8192] mask, segment ids, dropout 0.1), GPT-2's widths
(D=64) dense (B=4, S=1024, mask, dropout) and varlen (8 sequences in 4096,
mask, segment ids, dropout), and chip_smoke.py's FA2_EDGE_BIAS forms (a
key-padding bias, rows not 16-byte aligned at Sk 1501 and 1502, a
transposed view; head_dim 128 and 64): out rows to the row rule, the LSE
of live rows to 1e-3, and bitwise against the first version; the first
four timed in turns, the mask alone beside SDPA with the same float mask.
With ``--require-bitwise`` the probe exits 1 unless every version's out
and LSE are bitwise the first version's (``--old parent=...``) on every
case, kExtra or not.  Each build prints every K4 instance's registers,
stack and spills.  The card's name and power limit head the output.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import entry_args  # noqa: E402
import ptxas_report  # noqa: E402

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIG = [P] * 7 + [I] * 7 + [F, I, I, P]
SIG_MASKED = [P] * 12 + [I] * 7 + [F, I, I, P]  # + the tile metadata and count
# whether each comparison with the first version that ran a case was bitwise
BITWISE = []
# kExtra cases: (label, B, Sq, Sk, H, Hk, D, causal, masks, bias, dropout,
# timed); masks: "varlen" (ABI_LENS) or "varlen64" (GPT2_LENS) or None;
# bias: a shape for chip_smoke._rand_bias or a kind of _edge_bias
EXTRA_CASES = (
    ("mask alone, dense", 2, 2048, 2048, 32, 8, 128, True, None, (2, 1, 2048, 2048), False,
     True),
    ("varlen, mask, segment ids, dropout", 1, 8192, 8192, 32, 8, 128, False, "varlen",
     (8192, 8192), True, True),
    ("GPT-2 dense, mask, dropout", 4, 1024, 1024, 12, 12, 64, True, None, (4, 1, 1024, 1024),
     True, True),
    ("GPT-2 varlen, mask, segment ids, dropout", 1, 4096, 4096, 12, 12, 64, False, "varlen64",
     (4096, 4096), True, True),
)


def takes_masks(src: Path) -> bool:
    """Whether ``fatt_flash_fwd`` of ``src`` takes the tile metadata."""
    text = src.read_text()
    head = text[text.index('extern "C" int fatt_flash_fwd('):]
    return "qmeta" in head[:head.index(")")]


def build(name, src_dir, out_dir):
    from flash_attn_tpu_torch import _build

    lib = out_dir / f"lib{name}.so"
    cmd = [_build.nvcc_path(), *_build._ARCH, *_build._FLAGS, "-Xptxas", "-v", "-shared",
           "-I", str(src_dir), "-o", str(lib), str(src_dir / "flash_fwd.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"{name}: nvcc failed\n{res.stdout}{res.stderr}")
    rows = ptxas_report.parse(res.stderr)
    names = ptxas_report.demangle([r["name"] for r in rows])
    info = " | ".join(f"{n[n.find('flash_fwd_kernel'):n.find('>(') + 1]}: {r['regs']} registers, "
                      f"stack {r.get('stack', 0)}, spill st/ld {r.get('spill_st', 0)}/"
                      f"{r.get('spill_ld', 0)}" for r, n in zip(rows, names))
    info += "".join(" | " + x.strip() for x in res.stderr.splitlines()
                    if re.search(r"wgmma|arning", x))
    src = src_dir / "flash_fwd.cu"
    masked = takes_masks(src)
    so = ctypes.CDLL(str(lib))
    fn = entry_args.bind(so.fatt_flash_fwd, src, "fatt_flash_fwd", SIG_MASKED if masked else SIG)
    # the entry with a bias and dropout explicit, where it takes them (and
    # no ALiBi, return_softmax or clamped_verify, where it takes those)
    extra = None
    if "keep_div" in src.read_text():
        raw = so.fatt_flash_fwd
        none = entry_args.SURFACE_ARGS[1] if entry_args.takes_surface(src) else ()
        none += (0,) * entry_args.takes_window_idx(src)

        def extra(*args, raw=raw, none=none):
            return raw(*args[:-1], *none, args[-1])
    return (fn, masked, "launch<128, false, true" in src.read_text(), extra,
            "launch<128, true, true" in src.read_text()), info


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", action="append", default=[], help="NAME=DIR of another flash_fwd.cu")
    ap.add_argument("--require-bitwise", action="store_true",
                    help="fail unless every version's out and LSE are bitwise the first "
                         "version's on every case")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("k4_probe: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import cuda_ms, k4_flops, row_err
    from flash_attn_tpu_torch.ops import flash_fwd as ff
    from flash_attn_tpu_torch.ops.rope import rope_cos_sin

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    out_dir = ROOT / "flash_attn_tpu_torch" / "_build" / "k4_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    g = torch.Generator(device="cuda").manual_seed(3)
    B, S, H, Hk, D = 1, 2048, 32, 8, 128
    q = torch.randn((B, S, H, D), generator=g, device="cuda", dtype=torch.bfloat16)
    k = torch.randn((B, S, Hk, D), generator=g, device="cuda", dtype=torch.bfloat16)
    v = torch.randn((B, S, Hk, D), generator=g, device="cuda", dtype=torch.bfloat16)
    cos, sin = rope_cos_sin(torch.arange(S, device="cuda")[None], D, 500000.0)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device="cuda")
    ptrs = [t.data_ptr() for t in (q, k, v, cos, sin, out, lse)]
    eff = float(D ** -0.5 * ff.LOG2E)
    flops = k4_flops(B, S, S, H, D)
    refs = {c: ff.flash_fwd_plain(q, k, v, True, D ** -0.5, cos, sin, c) for c in (True, False)}
    masked_cases = _masked_cases(torch, ff)
    local_cases = _local_cases(torch, ff)
    masked_local = _masked_local_cases(torch, ff)
    olds = [tuple(o.split("=", 1)) for o in args.old]
    fns = {}
    for name, src in [*olds, ("this", ROOT / "flash_attn_tpu_torch" / "csrc")]:
        fns[name], info = build(name, Path(src), out_dir)
        print(f"[build] {name}: {info}", flush=True)
    order = [n for n, _ in olds] + ["this", "this"] + [n for n, _ in reversed(olds)]
    first = {}  # softmax mode -> the first version's (out, lse)
    for name in order:
        fn, masked, local128, _, masked_local128 = fns[name]
        line = []
        for clamped in (True, False):
            def call(fn=fn, clamped=clamped, none=(None,) * (5 * masked)):
                return fn(*ptrs, *none, B, S, S, H, Hk, D, 0, eff, 1, int(clamped),
                          torch.cuda.current_stream().cuda_stream)
            assert call() == 0
            torch.cuda.synchronize()
            rout, rlse = refs[clamped]
            _, share = row_err(out, rout)
            lerr = float((lse - rlse).abs().max())
            f_out, f_lse = first.setdefault(clamped, (out.clone(), lse.clone()))
            same = torch.equal(out, f_out) and torch.equal(lse, f_lse)
            BITWISE.append(same)
            ms = cuda_ms(torch, call)
            line.append(f"{'clamped' if clamped else 'online'} {ms:.4f} ms "
                        f"({flops / ms / 1e9:.1f} TFLOP/s), share {share:.3f}, lse err {lerr:.2e}, "
                        f"bitwise {order[0]}'s {same}")
        print(f"[turn] {name}: " + "; ".join(line), flush=True)
        if masked:
            print(f"[turn] {name} masked: " + "; ".join(
                _masked_turn(torch, fn, case, first, name) for case in masked_cases),
                flush=True)
        if hasattr(fn, "raw"):
            print(f"[turn] {name} with window and softcap args: " + "; ".join(
                _local_turn(torch, fn.raw, case, first, name) for case in local_cases
                if local128 or not case[7]), flush=True)
        if masked_local128:
            print(f"[turn] {name} masked, with window and softcap args: " + "; ".join(
                _local_turn(torch, functools.partial(fn.raw, window_idx=case[7]), case, first,
                            name) for case in masked_local
                if fn.takes_window_idx or not case[7]), flush=True)
    del masked_cases, local_cases, masked_local
    torch.cuda.empty_cache()
    ok = _extra_cases(torch, fns, [n for n, _ in olds])
    shutil.rmtree(out_dir, ignore_errors=True)
    bitwise = all(BITWISE)
    print(f"[probe] every version bitwise {order[0]}'s on every case: {bitwise}; rows held: "
          f"{ok}", flush=True)
    return 0 if ok and (bitwise or not args.require_bitwise) else 1


def _extra_cases(torch, fns, olds) -> bool:
    """EXTRA_CASES and FA2_EDGE_BIAS through every version whose entry
    takes a bias and dropout: held to fwd_plain, bitwise against the first
    version, the timed ones in turns.  Returns whether every row held."""
    import torch.nn.functional as F_

    from chip_smoke import (ABI_LENS, DROP_RATE, DROP_SEED, FA2_EDGE_BIAS, GPT2_LENS,
                            _edge_bias, _rand_bias, _sdpa_mask, _varlen_masks, cuda_ms,
                            fwd_plain, row_err)
    from flash_attn_tpu_torch.ops import flash_fwd as ff

    names = [n for n in [*olds, "this"] if fns[n][3] is not None]
    turns = [n for n in names if n != "this"]
    turns = turns + ["this", "this"] + turns[::-1]
    edge = tuple((f"{kind} bias", B, Sq, Sk, H, Hk, D, causal, None, kind, drop, False)
                 for B, Sq, Sk, H, Hk, D, causal, kind, drop in FA2_EDGE_BIAS)
    g = torch.Generator(device="cuda").manual_seed(29)
    ok = True
    for label, B, Sq, Sk, H, Hk, D, causal, masks, bias, dropout, timed in EXTRA_CASES + edge:
        q, k, v = (torch.randn((B, S, h, D), generator=g, device="cuda", dtype=torch.bfloat16)
                   for S, h in ((Sq, H), (Sk, Hk), (Sk, Hk)))
        m = None if masks is None else _varlen_masks(
            torch, ABI_LENS if masks == "varlen" else GPT2_LENS)
        b = (_edge_bias(torch, g, bias, B, H, Sq, Sk) if isinstance(bias, str)
             else _rand_bias(torch, g, bias))
        b4 = ff.bias4(b, B, H, Sq, Sk)
        drop = ff.Dropout(DROP_RATE, DROP_SEED) if dropout else None
        rout, rlse = fwd_plain((q, k, v, causal, D ** -0.5, None, None, False, m, None, None, b4,
                                drop))
        live = rlse > -1e29
        out = torch.empty_like(q)
        lse = torch.empty((B, H, Sq), dtype=torch.float32, device="cuda")
        tiles = (None,) * 4 if m is None else ff._tiles(m, B, Sq, Sk)
        cargs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), None, None, out.data_ptr(),
                 lse.data_ptr(), *(None if x is None else x.data_ptr() for x in tiles), None, B,
                 Sq, Sk, H, Hk, D, 0, float(D ** -0.5 * ff.LOG2E), int(causal), 0, -1, -1, 0.0,
                 *ff.extra_args(b4, drop)]
        what = (f"{label} (B={B}, Sq={Sq}, Sk={Sk}, H={H}, Hk={Hk}, D={D}, "
                f"{'causal' if causal else 'not causal'}, bias strides {tuple(b4.stride())})")
        first = None
        for name in names:
            def call(name=name):
                return fns[name][3](*cargs, torch.cuda.current_stream().cuda_stream)
            assert call() == 0, name
            torch.cuda.synchronize()
            _, share = row_err(out, rout)
            lerr = float((lse - rlse).abs()[live].max())
            first = first or (name, out.clone(), lse.clone())
            same = torch.equal(out, first[1]) and torch.equal(lse, first[2])
            BITWISE.append(same)
            held = share <= 1.0 and lerr <= 1e-3
            ok = ok and held
            print(f"[extra] {what}, {name}: share of the row tolerance {share:.3f}, lse err "
                  f"{lerr:.2e}; bitwise {first[0]}'s {same}; {'held' if held else 'MISSED'}",
                  flush=True)
        if timed:
            for name in turns:
                ms = cuda_ms(torch, lambda name=name: fns[name][3](
                    *cargs, torch.cuda.current_stream().cuda_stream))
                print(f"[extra turn] {what}, {name}: {ms:.4f} ms", flush=True)
            if dropout is False and masks is None:
                qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
                fm = _sdpa_mask(torch, None, causal, Sq, Sk, b4)
                lib = cuda_ms(torch, lambda: F_.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=fm, scale=D ** -0.5, enable_gqa=True))
                print(f"[extra library] {what}: SDPA with the same float mask {lib:.4f} ms",
                      flush=True)
                del qt, kt, vt, fm
        del q, k, v, b, b4, rout, rlse, out, lse
        torch.cuda.empty_cache()
    return ok


# (label, B, S, H, Hk, D, scale, rope theta, window, cap, needs K4's
# head_dim 128 kLocal instance) of the cases run through the entry with
# window and softcap: phase 2's Gemma-2-9B shape (with the window, without,
# and without the cap too: what the softcap costs), GPT-2's (head_dim 64,
# no window, no cap, no rope) and Gemma-2-27B's (head_dim 128 kLocal)
LOCAL_CASES = (
    ("D=256 window (4095, -1)", 1, 8192, 16, 8, 256, 1 / 16, 10000.0, (4095, -1), 50.0, False),
    ("D=256 no window", 1, 8192, 16, 8, 256, 1 / 16, 10000.0, None, 50.0, False),
    ("D=256 no window, no cap", 1, 8192, 16, 8, 256, 1 / 16, 10000.0, None, None, False),
    ("D=64 B=8 S=1024 H=Hk=12", 8, 1024, 12, 12, 64, 1 / 8, None, None, None, False),
    ("D=128 H=32 Hk=16 window (4095, -1)", 1, 8192, 32, 16, 128, 1 / 12, 10000.0, (4095, -1),
     50.0, True),
    ("D=128 H=32 Hk=16 no window", 1, 8192, 32, 16, 128, 1 / 12, 10000.0, None, 50.0, True),
)


def _local_cases(torch, ff):
    """(label, args of the C entry with window and softcap but the stream,
    out, lse, plain (out, lse), live pairs, (H, D), needs the 128 kLocal
    instance, the input tensors) of each LOCAL_CASES row (causal,
    clamped)."""
    from chip_smoke import fwd_plain
    from flash_attn_tpu_torch.ops.rope import rope_cos_sin

    g = torch.Generator(device="cuda").manual_seed(23)
    cases = []
    for label, B, S, H, Hk, D, scale, theta, window, cap, local128 in LOCAL_CASES:
        q = torch.randn((B, S, H, D), generator=g, device="cuda", dtype=torch.bfloat16)
        k = torch.randn((B, S, Hk, D), generator=g, device="cuda", dtype=torch.bfloat16)
        v = torch.randn((B, S, Hk, D), generator=g, device="cuda", dtype=torch.bfloat16)
        cos = sin = None
        if theta is not None:
            cos, sin = rope_cos_sin(torch.arange(S, device="cuda")[None], D, theta)
        out = torch.empty_like(q)
        lse = torch.empty((B, H, S), dtype=torch.float32, device="cuda")
        args = [None if t is None else t.data_ptr() for t in (q, k, v, cos, sin, out, lse)]
        args += [None] * 5 + [B, S, S, H, Hk, D, 0, float(scale * ff.LOG2E), 1, 1,
                              *(window or (-1, -1)), float(cap * ff.LOG2E) if cap else 0.0]
        ref = fwd_plain((q, k, v, True, scale, cos, sin, True, None, window, cap))
        n_live = B * int(ff.live_pairs(None, True, S, S, "cuda", window).sum())
        # the tensors ride along: the C entry holds only their addresses
        cases.append((label, args, out, lse, ref, n_live, (H, D), local128,
                      (q, k, v, cos, sin)))
    return cases


def _local_turn(torch, fn, case, first, name):
    """One LOCAL_CASES case's errors, time, TFLOP/s on live pairs, and
    whether its outputs are bitwise those of the first version that ran
    it."""
    from chip_smoke import cuda_ms, row_err

    label, args, out, lse, (rout, rlse), n_live, (H, D), _, _ = case

    def call():
        return fn(*args, torch.cuda.current_stream().cuda_stream)

    assert call() == 0
    torch.cuda.synchronize()
    _, share = row_err(out, rout)
    lerr = float((lse - rlse).abs().max())
    f_out, f_lse, f_name = first.setdefault(label, (out.clone(), lse.clone(), name))
    same = torch.equal(out, f_out) and torch.equal(lse, f_lse)
    BITWISE.append(same)
    ms = cuda_ms(torch, call)
    return (f"{label} {ms:.4f} ms ({4 * H * D * n_live / ms / 1e9:.1f} TFLOP/s on "
            f"{n_live} live pairs), share {share:.3f}, lse err {lerr:.2e}, bitwise "
            f"{f_name}'s {same}")


# (label, document lengths, S, causal, window, cap, clamped, the window on
# the indices) of the masked kLocal cases
MASKED_LOCAL_CASES = (
    ("packed positions, window (4095, -1)", (4600, 1200, 800, 600, 400, 300, 200, 92), 8192,
     False, (4095, -1), None, True, False),
    ("packed positions, window (4095, -1), cap 50", (4600, 1200, 800, 600, 400, 300, 200, 92),
     8192, False, (4095, -1), 50.0, True, False),
    ("segment ids, window (4095, -1) on the indices", (4800, 2000, 900, 492), 8192, True,
     (4095, -1), None, False, True),
    ("segment ids, window (4095, -1) on the indices, cap 50", (4800, 2000, 900, 492), 8192, True,
     (4095, -1), 50.0, False, True),
    ("segment ids, window (64, 32) on the indices, not causal", (512, 300, 256, 256, 200, 300,
     124, 100), 2048, False, (64, 32), None, False, True),
)


def _masked_local_cases(torch, ff):
    """MASKED_LOCAL_CASES as _local_turn takes them: (label, args of the
    C entry with window and softcap but the stream, out, lse, plain (out,
    lse), live pairs, (H, D), the window on the indices, the inputs); H=32,
    Hk=8, D=128, rope theta 1e4 on each document's positions."""
    from chip_smoke import _packed_positions, fwd_plain
    from flash_attn_tpu_torch.ops.rope import rope_cos_sin

    g = torch.Generator(device="cuda").manual_seed(24)
    H, Hk, D = 32, 8, 128
    cases = []
    for label, lens, S, causal, window, cap, clamped, idx in MASKED_LOCAL_CASES:
        seg, pos = (x.cuda() for x in _packed_positions(torch, lens, S))
        masks = ff.Masks(seg, seg, None, None) if idx else ff.Masks(seg, seg, pos, pos)
        q = torch.randn((1, S, H, D), generator=g, device="cuda", dtype=torch.bfloat16)
        k = torch.randn((1, S, Hk, D), generator=g, device="cuda", dtype=torch.bfloat16)
        v = torch.randn((1, S, Hk, D), generator=g, device="cuda", dtype=torch.bfloat16)
        cos, sin = rope_cos_sin(pos, D, 10000.0)
        qm, qr = ff.tile_meta(masks.q_segment_ids, masks.q_positions, 1, S)
        km, kr = ff.tile_meta(masks.kv_segment_ids, masks.kv_positions, 1, S)
        out = torch.empty_like(q)
        lse = torch.empty((1, H, S), dtype=torch.float32, device="cuda")
        args = [t.data_ptr() for t in (q, k, v, cos, sin, out, lse, qm, km, qr, kr)]
        args += [None, 1, S, S, H, Hk, D, 0, float(D ** -0.5 * ff.LOG2E), int(causal),
                 int(clamped), *ff.local_args(window, cap)]
        ref = fwd_plain((q, k, v, causal, D ** -0.5, cos, sin, clamped, masks, window, cap))
        n_live = int(ff.live_pairs(masks, causal, S, S, "cuda", window).sum())
        cases.append((label, args, out, lse, ref, n_live, (H, D), idx,
                      (q, k, v, cos, sin, qm, km, qr, kr)))
    return cases


def _masked_cases(torch, ff):
    """(label, args of the C entry with masks but the stream, out, lse, plain
    (out, lse), live pairs) at the packed and chunk shapes, clamped."""
    from chip_smoke import _packed_positions, _prompts
    from flash_attn_tpu_torch.ops.rope import rope_cos_sin

    g = torch.Generator(device="cuda").manual_seed(22)
    H, Hk, D = 32, 8, 128
    lens, _ = _prompts(128256)
    seg, pos = (x.cuda() for x in _packed_positions(torch, [int(n) for n in lens], 4096))
    cpos = torch.arange(1024, 1536, device="cuda", dtype=torch.int32)[None]
    kpos = torch.arange(4096, device="cuda", dtype=torch.int32)[None]
    cases = []
    for label, Sq, Sk, masks, qpos in (
            ("packed", 4096, 4096, ff.Masks(seg, seg, pos, pos), pos),
            ("chunk", 512, 4096, ff.Masks(None, None, cpos, kpos), cpos)):
        q = torch.randn((1, Sq, H, D), generator=g, device="cuda", dtype=torch.bfloat16)
        k = torch.randn((1, Sk, Hk, D), generator=g, device="cuda", dtype=torch.bfloat16)
        v = torch.randn((1, Sk, Hk, D), generator=g, device="cuda", dtype=torch.bfloat16)
        cos, sin = rope_cos_sin(qpos, D, 500000.0)
        qm, qr = ff.tile_meta(masks.q_segment_ids, masks.q_positions, 1, Sq)
        km, kr = ff.tile_meta(masks.kv_segment_ids, masks.kv_positions, 1, Sk)
        out = torch.empty_like(q)
        lse = torch.empty((1, H, Sq), dtype=torch.float32, device="cuda")
        args = [t.data_ptr() for t in (q, k, v, cos, sin, out, lse, qm, km, qr, kr)]
        args += [None, 1, Sq, Sk, H, Hk, D, 0, float(D ** -0.5 * ff.LOG2E), 0, 1]
        ref = ff.flash_fwd_plain(q, k, v, False, D ** -0.5, cos, sin, True, masks)
        n_live = int(ff.live_pairs(masks, False, Sq, Sk, "cuda").sum())
        cases.append((label, args, out, lse, ref, n_live, (q, k, v, cos, sin, qm, km, qr, kr)))
    return cases


def _masked_turn(torch, fn, case, first, name):
    """One masked case's errors, time, and whether its outputs are bitwise
    those of the first version that took masks (``first`` keeps them)."""
    from chip_smoke import cuda_ms, row_err

    label, args, out, lse, (rout, rlse), n_live, _ = case

    def call():
        return fn(*args, torch.cuda.current_stream().cuda_stream)

    assert call() == 0
    torch.cuda.synchronize()
    _, share = row_err(out, rout)
    lerr = float((lse - rlse).abs().max())
    f_out, f_lse, f_name = first.setdefault(label, (out.clone(), lse.clone(), name))
    same = torch.equal(out, f_out) and torch.equal(lse, f_lse)
    BITWISE.append(same)
    ms = cuda_ms(torch, call)
    return (f"{label} {ms:.4f} ms ({4 * 32 * 128 * n_live / ms / 1e9:.1f} TFLOP/s on live "
            f"pairs), share {share:.3f}, lse err {lerr:.2e}, bitwise {f_name}'s {same}")


if __name__ == "__main__":
    sys.exit(main())
