#!/usr/bin/env python3
"""K9 and K10 against other versions of their source: registers, errors,
times, and a mutant that must fail.

    python3 chip_tools/k9_probe.py [--old NAME=DIR ...]

Each DIR holds a ``flash_bwd.cu`` (and the ``common.cuh`` it includes),
for example the parent tree's ``flash_attn_tpu_torch/csrc`` unpacked by
``git archive``.  Five C interfaces are known: this tree's (as the next
and also the ALiBi slopes and K9's dS, passed as none), the one before it
(as the next, and both also take segment ids and positions, a bias and
dropout, passed as none here), the one before that (K9 also writes R(q), which K10 reads,
and both take a window and a softcap), the one before that without
window and softcap, and the earlier one in which both passes rotate q
themselves.  Each version, this tree's
``csrc/flash_bwd.cu`` and three mutants of it compile together
(``-Xptxas -v``, the flags of ``_build.py``) into their own libraries
under ``flash_attn_tpu_torch/_build/k9_probe/``; each kernel instance's
registers and spills are printed.  The mutants: ``mutant`` (K9 skips its
second K/V tile, K10 its second query tile, in every instance),
``no_dt`` (dS is not multiplied by the cap's 1 - t^2) and ``no_tanh``
(the scores are not capped: P from the raw scores).  Each version
launches through ctypes at chip_smoke.py's K9/K10 cases (``BWD_CASES``)
that fill the kernels' rows: the Llama training shape (B=1, S=2048, H=32,
Hk=8, D=128, causal, rope) and, where the source takes them, Gemma-2-9B's
(B=1, S=8192, H=16, Hk=8, D=256, causal, rope, softcap 50, scale 1/16)
with the window (4095, -1) and without, GPT-2's (B=8, S=1024,
H=Hk=12, D=64, causal, no rope) and, where the source builds the head_dim
128 kLocal instances, Gemma-2-27B's (B=1, S=8192, H=32, Hk=16, D=128,
causal, rope, softcap 50, scale 1/12) with the window and without; and,
checked only, at the cases whose scores bend the cap (S=2048 at D=256 and
at 27B's D=128, cap 5, with the window (1023, -1) and without).  Each is held to ``flash_bwd_plain``
as chip_smoke.py holds K9 and K10: dq, and dk and dv summed over each
GQA group, every row within 2^-6 of its largest |ref| (plus the floors);
the worst share of that tolerance is printed.  The tile mutant must
exceed it everywhere, the cap's mutants where the cap bends (elsewhere
their reading is printed: scores of ~N(0, 1) under cap 50 do not show
them); the probe exits 1 otherwise, or when a version misses its
tolerance.  PEAKY, a case held to nothing, is reported after them: q x8
at cap 50 makes the first queries' softmax one-hot, so their dq is fp32
noise on both sides.  Where a version that is not a mutant misses, its
worst dq rows are printed against an fp64 reference.  Times: CUDA
events over 20 launches and CUDA-graph replays, in turns (old..., this,
this, ...old reversed; at D=256 only the versions that take a window, at
D=64 only those that take head_dim 64, at 27B's only those that build its
instances),
and K10 followed by the reduction ``flash_bwd`` makes of its outputs
(the sum over each GQA group, then dk and dv in bf16 as [B, Sk, Hk, D]).
Each check line also says whether dq, dk and dv are bitwise those of the
first version.
Then the kOpt instances (segment ids, positions, the bias, dropout) on
``OPT_CASES``, in every version whose C entries take them: the bias alone
at the dense shape of phase 18 (B=2, S=2048, H=32, Hk=8, D=128, causal, a
[2, 1, 2048, 2048] fp32 mask), phase 18's varlen call (8 sequences in
8192 tokens, causal in each) with the mask, segment ids and dropout, with
segment ids and dropout, and with segment ids alone, phase 19's packed
documents with rope, GPT-2's widths (D=64) dense and varlen with the mask
and dropout, and chip_smoke.py's ``FA2_EDGE_BIAS`` (a key-padding bias, rows
not 16-byte aligned, a transposed view; head_dim 128 and 64, causal or
not).  Each version is held to ``flash_bwd_plain`` by the row rule (dq
rows of queries with fewer than two live keys to the noise floor), and
the mutants ``mutant`` (always) and ``bias_stage`` (K9 and K10 read the
other ring stage's bias; where a bias is given) must miss.  With
``--require-bitwise`` every version that is not a mutant must give dq, dk
and dv bitwise the first version's on every case, or the probe exits 1.
The timed cases run in turns as above; the dense bias-alone case also
gives cuDNN's backward on the same float mask (device time by
torch.profiler).
Then the kLocal and kOpt instances (the window and the softcap with
segment ids and positions, head_dim 128) on ``LOCAL_SEG_CASES``, in every
version whose C entries take ``window_idx``: Mistral-7B's training row
(H=32, Hk=8, four documents of 4800, 2000, 900 and 492 in 8192, rope on
each document's positions, causal, window (4095, -1)) with segment ids
alone (the window on the indices, the twin instance) and with segment ids
and positions (the window on the positions), the windowed ring's first
off-diagonal step (positions alone, 4096 queries after 4096 keys), a
two-sided window (64, 32) not causal on the indices, and the cap-5 pair
(S=2048, window (1023, -1), on the indices and on the positions) where
the cap bends: each held to ``flash_bwd_plain`` by the row rule, the tile
mutant missing everywhere and the cap's mutants where the cap bends; the
timed ones in turns beside SDPA's backward with the same boolean mask.
The card's name and power limit head the output.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
L, U = ctypes.c_int64, ctypes.c_uint32
# the options (tile metadata, bias, dropout) of the "opt" interface and
# their values for none
OPT = [P] * 4 + [P, L, L, L, L, I, U, U, F]
NO_OPT = (None,) * 4 + (None, 0, 0, 0, 0, 0, 0, 0, 1.0)
# (dq entry, dkv entry) argument types of each interface; "surface" is
# "opt" with the ALiBi slopes (both) and dS (K9) after the options, passed
# null by ``NO_SURFACE``; "idx" is "surface" with window_idx after them
SIGS = {"idx": ([P] * 10 + [I] * 7 + [F, I, I, I, F] + OPT + [P, P, I, P],
                [P] * 8 + [I] * 6 + [F, I, I, I, F] + OPT + [P, I, P]),
        "surface": ([P] * 10 + [I] * 7 + [F, I, I, I, F] + OPT + [P, P, P],
                    [P] * 8 + [I] * 6 + [F, I, I, I, F] + OPT + [P, P]),
        "opt": ([P] * 10 + [I] * 7 + [F, I, I, I, F] + OPT + [P],
                [P] * 8 + [I] * 6 + [F, I, I, I, F] + OPT + [P]),
        "local": ([P] * 10 + [I] * 7 + [F, I, I, I, F, P], [P] * 8 + [I] * 6 + [F, I, I, I, F, P]),
        "rq": ([P] * 10 + [I] * 7 + [F, I, P], [P] * 8 + [I] * 6 + [F, I, P]),
        "rotate": ([P] * 9 + [I] * 7 + [F, I, P], [P] * 10 + [I] * 7 + [F, I, P])}
# (K9's, K10's) null surface arguments of each interface (and window_idx 0)
NO_SURFACE = {abi: ((None, None, 0), (None, 0)) if abi == "idx" else
              ((None, None), (None,)) if abi == "surface" else ((), ()) for abi in SIGS}
# the interfaces that take a window and a softcap; those that take the kOpt
# options
LOCAL_ABIS = ("local", "opt", "surface", "idx")
OPT_ABIS = ("opt", "surface", "idx")
# edits of this tree's source, each (anchor, replacement, times it
# matches): the mutant adds a `continue` after the tile's offset in each
# loop; no_dt drops dS's factor 1 - t^2 in both passes; no_tanh caps
# nothing (t = s / cap, so P is the uncapped one)
K9 = "    const int k0 = tile_of(t) * kRows;\n"
K10 = "    float st[32], dpt[32];\n"
EDITS = {"mutant": ((K9, K9 + "if (t == 1) { __syncthreads(); continue; }\n", 1),
                    (K10, "if (it == 1) { __syncthreads(); continue; }\n" + K10, 1)),
         "no_dt": (("        if (capped) x[e] *= dt;\n", "", 4),),
         "no_tanh": (("fatt::tanh_exp2(s[4 * j + e] * cap_in)", "(s[4 * j + e] * cap_in)", 2),
                     ("fatt::tanh_exp2(st[4 * j + e] * cap_in)", "(st[4 * j + e] * cap_in)", 2)),
         # the staged bias read from the ring's other stage
         "bias_stage": (("bias_my + (t & 1) *", "bias_my + ((t + 1) & 1) *", 1),
                        ("bias_my + (it & 1) *", "bias_my + ((it + 1) & 1) *", 1))}
CAP_MUTANTS = ("no_dt", "no_tanh")
BIAS_MUTANTS = ("bias_stage",)
# the kOpt cases: (name, B, Sq, Sk, H, Hk, D, causal, masks, bias, dropout,
# timed); masks: "varlen" (phase 18's sequences, ABI_LENS), "varlen64"
# (GPT2_LENS), "docs" (phase 19's packed documents, with rope) or None;
# bias: a shape for chip_smoke._rand_bias, a kind of chip_smoke._edge_bias
# or None
OPT_CASES = (
    ("bias alone, dense", 2, 2048, 2048, 32, 8, 128, True, None, (2, 1, 2048, 2048), False,
     True),
    ("bias, segments, dropout, varlen", 1, 8192, 8192, 32, 8, 128, False, "varlen",
     (8192, 8192), True, True),
    ("segments, dropout, varlen", 1, 8192, 8192, 32, 8, 128, False, "varlen", None, True, True),
    ("segments alone, varlen", 1, 8192, 8192, 32, 8, 128, False, "varlen", None, False, True),
    ("packed documents, rope", 1, 2048, 2048, 32, 8, 128, True, "docs", None, False, True),
    ("GPT-2 bias, dropout, dense", 4, 1024, 1024, 12, 12, 64, True, None, (4, 1, 1024, 1024),
     True, True),
    ("GPT-2 bias, segments, dropout, varlen", 1, 4096, 4096, 12, 12, 64, False, "varlen64",
     (4096, 4096), True, True),
)
# the kLocal and kOpt cases: (name, documents (None: the ring's step),
# S, causal, positions given, window, cap, timed); H=32, Hk=8, D=128
LOCAL_SEG_CASES = (
    ("Mistral packed, window on the indices", (4800, 2000, 900, 492), 8192, True, False,
     (4095, -1), None, True),
    ("Mistral packed, window on the positions", (4800, 2000, 900, 492), 8192, True, True,
     (4095, -1), None, True),
    ("ring step, positions alone", None, 4096, False, True, (4095, -1), None, False),
    ("two-sided (64, 32) on the indices, not causal", (512, 300, 256, 256, 200, 300, 124, 100),
     2048, False, False, (64, 32), None, False),
    ("cap 5, window on the indices", (1024, 600, 424), 2048, True, False, (1023, -1), 5.0,
     False),
    ("cap 5, window on the positions", (1024, 600, 424), 2048, True, True, (1023, -1), 5.0,
     False),
)
# reported, held to nothing (B, Sq, Sk, H, Hk, D, causal, rope, window, cap, q_mult)
PEAKY = (1, 2048, 2048, 16, 8, 256, True, True, (1023, -1), 50.0, 8.0)


def takes(src: Path, c) -> bool:
    """Whether the flash_bwd.cu in ``src`` builds case ``c``'s instance:
    its head dim, and at 128 with a window or a softcap the kLocal one."""
    text = (src / "flash_bwd.cu").read_text()
    if c.D == 128 and (c.window is not None or c.cap is not None):
        return "launch_dq<128, true" in text
    return c.D == 128 or f"launch_dq<{c.D}" in text


def interface(src: Path) -> str:
    text = src.read_text()
    head = text[text.index('extern "C" int fatt_flash_bwd_dq('):]
    head = head[:head.index(")")]
    if "window_idx" in head:
        return "idx"
    if "alibi2" in head:
        return "surface"
    if "inv_keep" in head:
        return "opt"
    return "local" if "window" in head else "rq" if "void* rq" in head else "rotate"


def registers(ptxas: str) -> str:
    """'dq_kernel<128> 167 registers, spill 0/0 bytes; ...' from -Xptxas -v."""
    out, name = [], None
    for line in ptxas.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"(dkv_kernel|dq_kernel)"
                          r"(?:ILi(\d+)E(?:Lb([01])E)?(?:Lb([01])E)?(?:Lb([01])E)?"
                          r"(?:Lb([01])E)?)?", m.group(1))
            name = None if k is None else (f"{k.group(1)}<{k.group(2) or 128}"
                                           f"{', local' if k.group(3) == '1' else ''}"
                                           f"{', opt' if k.group(4) == '1' else ''}"
                                           f"{', surface' if k.group(5) == '1' else ''}"
                                           f"{', idx' if k.group(6) == '1' else ''}>")
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spill = f"spill {m.group(1)}/{m.group(2)} bytes"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append(f"{name} {m.group(1)} registers, {spill}")
            name = None
    return "; ".join(out)


def edited(src_dir: Path, out_dir: Path, name: str) -> Path:
    """A copy of src_dir's sources with EDITS[name] applied."""
    dst = out_dir / f"{name}_src"
    dst.mkdir(parents=True, exist_ok=True)
    shutil.copy(src_dir / "common.cuh", dst)
    text = (src_dir / "flash_bwd.cu").read_text()
    for anchor, new, times in EDITS[name]:
        if text.count(anchor) != times:
            raise RuntimeError(f"{name}: anchor not found {times} times: {anchor!r}")
        text = text.replace(anchor, new)
    (dst / "flash_bwd.cu").write_text(text)
    return dst


def compile_lib(name, src_dir, out_dir):
    """nvcc of src_dir's flash_bwd.cu: (library, the completed process)."""
    from flash_attn_tpu_torch import _build

    lib = out_dir / f"lib{name}.so"
    cmd = [_build.nvcc_path(), *_build._ARCH, *_build._FLAGS, "-Xptxas", "-v", "-shared",
           "-I", str(src_dir), "-o", str(lib), str(src_dir / "flash_bwd.cu")]
    return lib, subprocess.run(cmd, capture_output=True, text=True)


def load(name, src_dir, lib, res):
    if res.returncode != 0:
        raise RuntimeError(f"{name}: nvcc failed\n{res.stdout}{res.stderr}")
    warn = [x.strip() for x in res.stderr.splitlines() if re.search(r"wgmma|arning", x)]
    info = registers(res.stderr) + "".join(f" | {x}" for x in warn)
    so = ctypes.CDLL(str(lib))
    abi = interface(src_dir / "flash_bwd.cu")
    fns = []
    for fn, sig in zip((so.fatt_flash_bwd_dq, so.fatt_flash_bwd_dkv), SIGS[abi]):
        fn.argtypes = sig
        fn.restype = ctypes.c_int
        fns.append(fn)
    return abi, fns, info


class OptCase:
    """One of OPT_CASES or chip_smoke.py's FA2_EDGE_BIAS: its inputs (out
    and lse from this tree's K4 with the same options), the kOpt arguments
    of the C entries, the plain version's outputs and the dq floor."""

    def __init__(self, torch, name, B, Sq, Sk, H, Hk, D, causal, masks, bias, dropout, timed):
        from chip_smoke import (ABI_LENS, DROP_RATE, DROP_SEED, GPT2_LENS, PACKED_DOCS,
                                _edge_bias, _live_keys, _packed_docs, _rand_bias,
                                _varlen_masks, bwd_plain)
        from flash_attn_tpu_torch.ops import flash_bwd as fb
        from flash_attn_tpu_torch.ops import flash_fwd as ff
        from flash_attn_tpu_torch.ops.rope import rope_cos_sin

        self.name, self.B, self.Sq, self.Sk, self.H, self.Hk, self.D = name, B, Sq, Sk, H, Hk, D
        self.causal, self.timed, self.scale = causal, timed, D ** -0.5
        g = torch.Generator(device="cuda").manual_seed(7)

        def rnd(*shape):
            return torch.randn(shape, generator=g, device="cuda", dtype=torch.bfloat16)

        self.q, self.k, self.v = rnd(B, Sq, H, D), rnd(B, Sk, Hk, D), rnd(B, Sk, Hk, D)
        self.dout = rnd(B, Sq, H, D)
        self.cos = self.sin = None
        m = None
        if masks in ("varlen", "varlen64"):
            m = _varlen_masks(torch, ABI_LENS if masks == "varlen" else GPT2_LENS)
        elif masks == "docs":
            seg, pos = _packed_docs(torch, PACKED_DOCS)
            m = ff.Masks(seg, seg, None, None)
            self.cos, self.sin = rope_cos_sin(pos, D, 500000.0)
        if bias is None:
            self.bias = None
        elif isinstance(bias, str):
            self.bias = _edge_bias(torch, g, bias, B, H, Sq, Sk)
        else:
            self.bias = _rand_bias(torch, g, bias)
        self.has_bias = self.bias is not None
        b4 = ff.bias4(self.bias, B, H, Sq, Sk)
        drop = ff.Dropout(DROP_RATE, DROP_SEED) if dropout else None
        out, self.lse = ff.flash_fwd_cuda(self.q, self.k, self.v, causal, self.scale, self.cos,
                                          self.sin, False, m, None, None, b4, drop)
        self.delta = (self.dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        del out
        self.masks, self.b4, self.drop = m, b4, drop
        # K4's tile metadata, held here: opt_args takes _tiles' pointers
        self.tiles = None if m is None else ff._tiles(m, B, Sq, Sk)
        self.opt = fb.opt_args(m, b4, drop, B, Sq, Sk)
        args = (self.q, self.k, self.v, self.dout, self.lse, self.delta, causal, self.scale,
                self.cos, self.sin, None, None, m, b4, drop)
        self.ref = bwd_plain(args)
        counts = _live_keys(torch, m, causal, Sq, Sk, b4, H)
        self.floor = torch.where(counts < 2, 2.0 ** -12 * float(self.ref[0].abs().max()), 1e-6)
        live = ff.live_pairs(m, causal, Sq, Sk, "cuda")
        self.gemm = 2 * D * H * int(live.sum()) * (1 if m is not None else B)

    def cudnn_ms(self, torch):
        """cuDNN's (SDPA's) backward with the same float mask, device time,
        and its backend."""
        import torch.nn.functional as F

        from chip_smoke import _sdpa_mask, sdpa_bwd_device_ms

        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                      for x in (self.q, self.k, self.v))
        fm = _sdpa_mask(torch, self.masks, self.causal, self.Sq, self.Sk, self.b4)
        o = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=fm, scale=self.scale,
                                           enable_gqa=True)
        do_t = self.dout.transpose(1, 2).contiguous()
        ms, backend, _ = sdpa_bwd_device_ms(
            torch, lambda: torch.autograd.grad(o, (qt, kt, vt), do_t, retain_graph=True), calls=5)
        return ms, backend


class LocalSegCase:
    """One of LOCAL_SEG_CASES: its inputs (out and lse from this tree's
    K4 with the same masks, window and cap; rope on the documents'
    positions), the C entries' option arguments, the plain version's
    outputs (per query head), the dq floor and the live pairs."""

    def __init__(self, torch, name, docs, S, causal, positions, window, cap, timed):
        from chip_smoke import _packed_positions, bwd_plain
        from flash_attn_tpu_torch.ops import flash_bwd as fb
        from flash_attn_tpu_torch.ops import flash_fwd as ff
        from flash_attn_tpu_torch.ops.rope import rope_cos_sin

        H, Hk, D = 32, 8, 128
        self.name, self.S, self.H, self.Hk, self.D = name, S, H, Hk, D
        self.causal, self.window, self.cap, self.timed = causal, window, cap, timed
        self.scale, self.bends = D ** -0.5, cap is not None and 1.0 / cap >= 0.1
        g = torch.Generator(device="cuda").manual_seed(9)

        def rnd(*shape):
            return torch.randn(shape, generator=g, device="cuda", dtype=torch.bfloat16)

        self.q, self.k, self.v, self.dout = rnd(1, S, H, D), rnd(1, S, Hk, D), rnd(1, S, Hk, D), \
            rnd(1, S, H, D)
        if docs is None:  # the ring's step: queries S..2S-1 after keys 0..S-1
            qpos = torch.arange(S, 2 * S, device="cuda", dtype=torch.int32)[None]
            kpos = qpos - S
            m = ff.Masks(None, None, qpos, kpos)
        else:
            seg, qpos = (x.cuda() for x in _packed_positions(torch, docs, S))
            kpos = qpos
            m = ff.Masks(seg, seg, qpos, kpos) if positions else ff.Masks(seg, seg, None, None)
        self.cos, self.sin = rope_cos_sin(qpos, D, 10000.0)
        out, self.lse = ff.flash_fwd_cuda(self.q, self.k, self.v, causal, self.scale, self.cos,
                                          self.sin, False, m, window, cap)
        self.delta = (self.dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        del out
        self.masks = m
        self.tiles = ff._tiles(m, 1, S, S)  # held: opt_args takes their pointers
        self.opt = fb.opt_args(m, None, None, 1, S, S)
        self.local = (*ff.local_args(window, cap), ff.window_idx(window, m))
        self.ref = bwd_plain((self.q, self.k, self.v, self.dout, self.lse, self.delta, causal,
                              self.scale, self.cos, self.sin, window, cap, m))
        live = ff.live_pairs(m, causal, S, S, "cuda", window)
        counts = live.sum(-1)[..., None].expand(-1, -1, H)
        self.floor = torch.where(counts < 2, 2.0 ** -12 * float(self.ref[0].abs().max()), 1e-6)
        self.live = live
        self.gemm = 2 * D * H * int(live.sum())

    def sdpa_ms(self, torch):
        """SDPA's backward with the same boolean mask (device time), and
        its backend."""
        import torch.nn.functional as F

        from chip_smoke import sdpa_bwd_device_ms
        from flash_attn_tpu_torch.ops.rope import rope_rotate

        qt = rope_rotate(self.q, self.cos, self.sin).transpose(1, 2).contiguous()
        qt.requires_grad_(True)
        kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True) for x in (self.k, self.v))
        o = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=self.live[:, None],
                                           scale=self.scale, enable_gqa=True)
        do_t = self.dout.transpose(1, 2).contiguous()
        ms, backend, _ = sdpa_bwd_device_ms(
            torch, lambda: torch.autograd.grad(o, (qt, kt, vt), do_t, retain_graph=True), calls=5)
        return ms, backend


class Case:
    """One of chip_smoke.py's BWD_CASES (Sq = Sk, causal): its inputs,
    references and operation count."""

    def __init__(self, torch, c):
        from chip_smoke import _bwd_case_inputs, _bwd_case_label, bwd_plain, one_key_floor
        from flash_attn_tpu_torch.ops import flash_fwd as ff
        from flash_attn_tpu_torch.ops.rope import rope_rotate

        assert c.Sq == c.Sk and c.causal, c
        self.name, self.S, self.H, self.Hk, self.D = _bwd_case_label(c), c.Sq, c.H, c.Hk, c.D
        self.B = c.B
        self.window, self.cap, self.bends = c.window, c.cap, c.bends
        self.scale = c.softmax_scale
        g = torch.Generator(device="cuda").manual_seed(5)
        (self.q, self.k, self.v, self.dout, self.lse, self.delta, self.cos,
         self.sin) = _bwd_case_inputs(torch, g, c)
        rdq, rdk, rdv = bwd_plain((self.q, self.k, self.v, self.dout, self.lse, self.delta,
                                   True, self.scale, self.cos, self.sin, c.window, c.cap))
        B, S, H, Hk, D = self.B, self.S, self.H, self.Hk, self.D
        self.ref = (rdq, *(x.reshape(B, Hk, H // Hk, S, D).sum(2) for x in (rdk, rdv)))
        self.floor = one_key_floor(torch, rdq, S, True)
        self.rq_ref = self.q if self.cos is None else rope_rotate(self.q, self.cos, self.sin)
        pairs = int(ff.live_pairs(None, True, S, S, "cuda", c.window).sum())
        self.gemm = 2 * D * B * H * pairs  # one product over the live pairs
        self.timed = c.row is not None


def worst_rows(torch, c, dq, n=4) -> str:
    """The ``n`` dq rows furthest outside their tolerance, each against an
    fp64 reference from the same inputs (R(q), k, v, dout, lse, delta; dS
    rounded to bf16, as the kernel and the plain version round it):
    its query, head, live keys, largest p, largest |fp64 value|, and the
    kernel's and the plain version's largest |error| against fp64 (of
    the first sequence)."""
    from flash_attn_tpu_torch.ops.flash_fwd import live_pairs
    from flash_attn_tpu_torch.ops.rope import rope_unrotate

    ref = c.ref[0]
    tol = 2.0 ** -6 * ref.abs().amax(-1) + c.floor
    share = ((dq - ref).abs().amax(-1) / tol)[0].reshape(-1)
    live = live_pairs(None, True, c.S, c.S, dq.device, c.window)[0]
    out = []
    for i in torch.argsort(share, descending=True)[:n].tolist():
        row, h = divmod(i, c.H)
        kk, vv = (x[0, :, h // (c.H // c.Hk)].double() for x in (c.k, c.v))
        s = kk @ c.rq_ref[0, row, h].double() * c.scale
        t = torch.tanh(s / c.cap) if c.cap else torch.zeros_like(s)
        s = c.cap * t if c.cap else s
        p = torch.where(live[row], torch.exp(s - c.lse[0, h, row].double()), 0.0)
        ds = p * (vv @ c.dout[0, row, h].double() - c.delta[0, h, row].double()) * (1 - t * t)
        ds = ds.to(torch.bfloat16).double()  # as both sides round it
        g = (ds @ kk * c.scale).float()
        if c.cos is not None:
            g = rope_unrotate(g[None, None, None], c.cos[..., row:row + 1, :],
                              c.sin[..., row:row + 1, :])[0, 0, 0]
        out.append(f"q {row} head {h}: share {share[i]:.3f}, {int(live[row].sum())} live keys, "
                   f"largest p {float(p.max()):.6f}, largest |fp64| {float(g.abs().max()):.4e}, "
                   f"|kernel - fp64| {float((dq[0, row, h] - g).abs().max()):.4e}, "
                   f"|plain - fp64| {float((ref[0, row, h] - g).abs().max()):.4e}")
    return "; ".join(out)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", action="append", default=[], help="NAME=DIR of another flash_bwd.cu")
    ap.add_argument("--require-bitwise", action="store_true",
                    help="fail unless every version that is not a mutant gives the first "
                         "version's outputs bitwise on every case")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("k9_probe: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import BWD_CASES, BwdCase, cuda_ms, graph_ms, row_err

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    out_dir = ROOT / "flash_attn_tpu_torch" / "_build" / "k9_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    olds = [tuple(o.split("=", 1)) for o in args.old]
    this = ROOT / "flash_attn_tpu_torch" / "csrc"
    srcs = [*olds, ("this", this), *((n, edited(this, out_dir, n)) for n in EDITS)]
    libs = {}
    with concurrent.futures.ThreadPoolExecutor(len(srcs)) as pool:
        built = [(name, src, pool.submit(compile_lib, name, Path(src), out_dir))
                 for name, src in srcs]
        for name, src, job in built:
            libs[name] = load(name, Path(src), *job.result())
            print(f"[build] {name} ({libs[name][0]}): {libs[name][2]}", flush=True)

    def runner(name, c):
        """(K9 call, K10 call, K10 then the GQA reduction flash_bwd makes of
        its outputs, outputs -> (dq, dk, dv) group-summed) of version
        ``name`` on case ``c``."""
        abi, (f9, f10), _ = libs[name]
        B, S, H, Hk, D, G = c.B, c.S, c.H, c.Hk, c.D, c.H // c.Hk
        sk_pad = -(-S // 64) * 64
        dq = torch.empty((B, S, H, D), dtype=torch.float32, device="cuda")
        rq = c.q if c.cos is None else torch.empty_like(c.q)  # K9 writes R(q) with rope
        dk = torch.empty((B, H, sk_pad, D), dtype=torch.float32, device="cuda")
        dv = torch.empty_like(dk)
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        common = [ptr(t) for t in (c.q, c.k, c.v, c.dout, c.lse, c.delta, c.cos, c.sin)]
        local = ()
        if abi in LOCAL_ABIS:
            local = (*(c.window or (-1, -1)), 0.0 if c.cap is None else c.cap * 1.4426950408889634)
        if abi in OPT_ABIS:
            local += NO_OPT
        s9, s10 = NO_SURFACE[abi]
        if abi in ("rq", *LOCAL_ABIS):
            c9 = lambda: f9(*common, ptr(dq), ptr(rq), B, S, S, H, Hk, D, 0, c.scale, 1,  # noqa
                            *local, *s9, stream())
            c10 = lambda: f10(ptr(rq), *common[1:6], ptr(dk), ptr(dv), B, S, S, H, Hk, D,  # noqa
                              c.scale, 1, *local, *s10, stream())
        else:
            c9 = lambda: f9(*common, ptr(dq), B, S, S, H, Hk, D, 0, c.scale, 1,  # noqa
                            stream())
            c10 = lambda: f10(*common, ptr(dk), ptr(dv), B, S, S, H, Hk, D, 0, c.scale,  # noqa
                              1, stream())

        def group_sum():
            return [x[:, :, :S].reshape(B, Hk, G, S, D).sum(2) for x in (dk, dv)]

        def c10_reduced():  # [B, Sk, Hk, D] bf16, as flash_bwd returns dk and dv
            c10()
            return [x.transpose(1, 2).to(torch.bfloat16) for x in group_sum()]

        def outs():
            return (dq, *group_sum(), torch.equal(rq, c.rq_ref) if abi != "rotate" else None)
        return c9, c10, c10_reduced, outs

    ok = True
    cases = [(x, True) for x in BWD_CASES if x.row is not None or x.bends]
    for bc, bound in cases + [(BwdCase(*PEAKY), False)]:
        c = Case(torch, bc)
        labels = [n for n, src in srcs if (c.D == 128 or libs[n][0] in LOCAL_ABIS)
                  and takes(Path(src), c) and (n not in CAP_MUTANTS or c.cap is not None)
                  and n not in BIAS_MUTANTS]
        first = None
        for label in labels:
            c9, c10, _, outs = runner(label, c)
            assert c9() == 0 and c10() == 0, label
            torch.cuda.synchronize()
            dq, dk, dv, rq_ok = outs()
            first = first or (dq.clone(), dk.clone(), dv.clone())
            same = all(torch.equal(a, b) for a, b in zip((dq, dk, dv), first))
            shares = [row_err(dq, c.ref[0], floor=c.floor)[1], row_err(dk, c.ref[1])[1],
                      row_err(dv, c.ref[2])[1]]
            held = max(shares) <= 1.0 and rq_ok is not False
            must_miss = label == "mutant" or (label in CAP_MUTANTS and c.bends)
            if bound and (label not in CAP_MUTANTS or c.bends):
                ok = ok and (not held if must_miss else held)
            if args.require_bitwise and label not in EDITS and not same:
                ok = False
            note = (" (reported, held to nothing)" if not bound else " (must miss)" if must_miss
                    else " (not bound to miss: the cap does not bend here)" if label in EDITS
                    else "")
            print(f"[check] {c.name}, {label}: share of the row tolerance dq {shares[0]:.3f}, "
                  f"dk {shares[1]:.3f}, dv {shares[2]:.3f}"
                  f"{'' if rq_ok is None else f'; R(q) bitwise {rq_ok}'}; bitwise {labels[0]}'s "
                  f"{same}; {'held' if held else 'missed'}{note}", flush=True)
            if not held and label not in EDITS:
                print(f"[rows] {c.name}, {label}: {worst_rows(torch, c, dq)}", flush=True)
        if not c.timed:
            continue
        turns = [n for n in labels if n not in EDITS and n != "this"]
        order = turns + ["this", "this"] + turns[::-1]
        for label in order:
            c9, c10, c10r, _ = runner(label, c)
            ms9, ms10 = cuda_ms(torch, c9), cuda_ms(torch, c10)
            g9, g10, g10r = graph_ms(torch, c9), graph_ms(torch, c10), graph_ms(torch, c10r)
            print(f"[turn] {c.name}, {label}: K9 {ms9:.4f} ms (graph {g9:.4f}, "
                  f"{3 * c.gemm / g9 / 1e9:.1f} TFLOP/s); K10 {ms10:.4f} ms (graph {g10:.4f}, "
                  f"{4 * c.gemm / g10 / 1e9:.1f} TFLOP/s); K9 + K10 graph {g9 + g10:.4f} ms; "
                  f"K10 and the GQA reduction (graph) {g10r:.4f} ms", flush=True)
        del c
        torch.cuda.empty_cache()

    def opt_runner(name, c):
        """(K9 call, K10 call, outputs -> (dq, dk, dv) per query head) of
        version ``name`` on OptCase ``c``."""
        abi, (f9, f10), _ = libs[name]
        s9, s10 = NO_SURFACE[abi]
        B, Sq, Sk, H, Hk, D = c.B, c.Sq, c.Sk, c.H, c.Hk, c.D
        dq = torch.empty((B, Sq, H, D), dtype=torch.float32, device="cuda")
        rq = c.q if c.cos is None else torch.empty_like(c.q)
        dk = torch.empty((B, H, Sk, D), dtype=torch.float32, device="cuda")
        dv = torch.empty_like(dk)
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        common = [ptr(t) for t in (c.q, c.k, c.v, c.dout, c.lse, c.delta, c.cos, c.sin)]
        nolocal = (-1, -1, 0.0)
        c9 = lambda: f9(*common, ptr(dq), ptr(rq), B, Sq, Sk, H, Hk, D, 0, c.scale,  # noqa
                        int(c.causal), *nolocal, *c.opt, *s9, stream())
        c10 = lambda: f10(ptr(rq), *common[1:6], ptr(dk), ptr(dv), B, Sq, Sk, H, Hk, D,  # noqa
                          c.scale, int(c.causal), *nolocal, *c.opt, *s10, stream())
        return c9, c10, lambda: (dq, dk, dv)

    from chip_smoke import FA2_EDGE_BIAS

    edge = tuple((f"{kind} bias", B, Sq, Sk, H, Hk, D, causal, None, kind, drop, False)
                 for B, Sq, Sk, H, Hk, D, causal, kind, drop in FA2_EDGE_BIAS)
    all_bitwise = True
    for spec in OPT_CASES + edge:
        c = OptCase(torch, *spec)
        label_of = (f"{c.name} (B={c.B}, Sq={c.Sq}, Sk={c.Sk}, H={c.H}, Hk={c.Hk}, D={c.D}, "
                    f"{'causal' if c.causal else 'not causal'})")
        labels = [n for n, _ in srcs if libs[n][0] in OPT_ABIS and n not in CAP_MUTANTS
                  and (n not in BIAS_MUTANTS or c.has_bias)]
        first = None
        for label in labels:
            c9, c10, outs = opt_runner(label, c)
            assert c9() == 0 and c10() == 0, label
            torch.cuda.synchronize()
            got = outs()
            first = first or tuple(x.clone() for x in got)
            same = all(torch.equal(a, b) for a, b in zip(got, first))
            shares = [row_err(got[0], c.ref[0], floor=c.floor)[1], row_err(got[1], c.ref[1])[1],
                      row_err(got[2], c.ref[2])[1]]
            held = max(shares) <= 1.0  # NaN (a mutant's stale stage) misses too
            must_miss = label in ("mutant", *BIAS_MUTANTS)
            ok = ok and (not held if must_miss else held)
            if label not in EDITS:
                all_bitwise = all_bitwise and same
                if args.require_bitwise and not same:
                    ok = False
            print(f"[opt] {label_of}, {label}: share of the row tolerance dq {shares[0]:.3f}, "
                  f"dk {shares[1]:.3f}, dv {shares[2]:.3f}; bitwise {labels[0]}'s {same}; "
                  f"{'held' if held else 'missed'}{' (must miss)' if must_miss else ''}",
                  flush=True)
        if c.timed:
            turns = [n for n in labels if n not in EDITS and n != "this"]
            for label in turns + ["this", "this"] + turns[::-1]:
                c9, c10, _ = opt_runner(label, c)
                ms9, ms10 = cuda_ms(torch, c9), cuda_ms(torch, c10)
                g9, g10 = graph_ms(torch, c9), graph_ms(torch, c10)
                print(f"[opt turn] {label_of}, {label}: K9 {ms9:.4f} ms (graph {g9:.4f}, "
                      f"{3 * c.gemm / g9 / 1e9:.1f} TFLOP/s); K10 {ms10:.4f} ms (graph "
                      f"{g10:.4f}, {4 * c.gemm / g10 / 1e9:.1f} TFLOP/s); K9 + K10 {ms9 + ms10:.4f}"
                      f" ms (graph {g9 + g10:.4f})", flush=True)
            if c.name == OPT_CASES[0][0]:
                lib_ms, backend = c.cudnn_ms(torch)
                print(f"[opt library] {label_of}: SDPA's backward with the same float mask, "
                      f"device time {'not measured' if lib_ms is None else f'{lib_ms:.4f}'} ms "
                      f"(backend {backend})", flush=True)
        del c
        torch.cuda.empty_cache()
    print(f"[opt] every version bitwise {srcs[0][0]}'s on every kOpt case: {all_bitwise}",
          flush=True)

    def local_seg_runner(name, c):
        """(K9 call, K10 call, outputs) of version ``name`` on
        LocalSegCase ``c``."""
        _, (f9, f10), _ = libs[name]
        S, H, Hk, D = c.S, c.H, c.Hk, c.D
        dq = torch.empty((1, S, H, D), dtype=torch.float32, device="cuda")
        rq = torch.empty_like(c.q)
        dk = torch.empty((1, H, S, D), dtype=torch.float32, device="cuda")
        dv = torch.empty_like(dk)
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        common = [ptr(t) for t in (c.q, c.k, c.v, c.dout, c.lse, c.delta, c.cos, c.sin)]
        wl, wr, cap2, idx = c.local
        c9 = lambda: f9(*common, ptr(dq), ptr(rq), 1, S, S, H, Hk, D, 0, c.scale,  # noqa
                        int(c.causal), wl, wr, cap2, *c.opt, None, None, idx, stream())
        c10 = lambda: f10(ptr(rq), *common[1:6], ptr(dk), ptr(dv), 1, S, S, H, Hk, D,  # noqa
                          c.scale, int(c.causal), wl, wr, cap2, *c.opt, None, idx, stream())
        return c9, c10, lambda: (dq, dk, dv)

    for spec in LOCAL_SEG_CASES:
        c = LocalSegCase(torch, *spec)
        label_of = (f"{c.name} (B=1, S={c.S}, H={c.H}, Hk={c.Hk}, D={c.D}, "
                    f"{'causal' if c.causal else 'not causal'}, window {c.window}"
                    f"{f', cap {c.cap:g}' if c.cap else ''})")
        labels = [n for n, _ in srcs if libs[n][0] == "idx" and n not in BIAS_MUTANTS
                  and (n not in CAP_MUTANTS or c.cap is not None)]
        first = None
        for label in labels:
            c9, c10, outs = local_seg_runner(label, c)
            assert c9() == 0 and c10() == 0, label
            torch.cuda.synchronize()
            got = outs()
            first = first or tuple(x.clone() for x in got)
            same = all(torch.equal(a, b) for a, b in zip(got, first))
            shares = [row_err(got[0], c.ref[0], floor=c.floor)[1], row_err(got[1], c.ref[1])[1],
                      row_err(got[2], c.ref[2])[1]]
            held = max(shares) <= 1.0
            must_miss = label == "mutant" or (label in CAP_MUTANTS and c.bends)
            if label not in CAP_MUTANTS or c.bends:
                ok = ok and (not held if must_miss else held)
            note = (" (must miss)" if must_miss else " (not bound to miss: the cap does not "
                    "bend here)" if label in CAP_MUTANTS else "")
            print(f"[local seg] {label_of}, {label}: share of the row tolerance dq "
                  f"{shares[0]:.3f}, dk {shares[1]:.3f}, dv {shares[2]:.3f}; bitwise "
                  f"{labels[0]}'s {same}; {'held' if held else 'missed'}{note}", flush=True)
        if c.timed:
            for label in [n for n in labels if n not in EDITS] * 2:
                c9, c10, _ = local_seg_runner(label, c)
                ms9, ms10 = cuda_ms(torch, c9), cuda_ms(torch, c10)
                g9, g10 = graph_ms(torch, c9), graph_ms(torch, c10)
                print(f"[local seg turn] {label_of}, {label}: K9 {ms9:.4f} ms (graph {g9:.4f}, "
                      f"{3 * c.gemm / g9 / 1e9:.1f} TFLOP/s on {c.gemm // (2 * c.D * c.H)} live "
                      f"pairs a head); K10 {ms10:.4f} ms (graph {g10:.4f}, "
                      f"{4 * c.gemm / g10 / 1e9:.1f} TFLOP/s)", flush=True)
            lib_ms, backend = c.sdpa_ms(torch)
            print(f"[local seg library] {label_of}: SDPA's backward with the same boolean mask, "
                  f"device time {'not measured' if lib_ms is None else f'{lib_ms:.4f}'} ms "
                  f"(backend {backend})", flush=True)
        del c
        torch.cuda.empty_cache()
    shutil.rmtree(out_dir, ignore_errors=True)
    print(f"[probe] {'ok' if ok else 'FAIL'}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
