#!/usr/bin/env python3
"""K8 (paged decode in decode mode, csrc/paged_decode.cu) and K2 (the
quantize-and-append, csrc/kv_append.cu) against earlier versions:
registers, errors, CUDA-graph times in turns, a mutant that must fail, and
the kernels that must stay bitwise.

    python3 chip_tools/k8_probe.py --old NAME=DIR [--old NAME=DIR ...]
                                   [--targets 264,528,792] [--variants a,b]
                                   [--uniform]

Each DIR holds an earlier tree's ``csrc`` (``common.cuh`` and the ``.cu``
files), for example the parent's ``flash_attn_tpu_torch/csrc`` unpacked by
``git archive``.  A K8 whose C entry takes ``split_len`` runs with the
split plan it shipped with (splits of the table's reach, repeated here)
and merges through its own tree's K1m; a K8 that takes an arrival
workspace splits the live walk and merges in the kernel.  Each version,
this tree's sources, a mutant of ``paged_decode.cu`` (split 1 walks no
tiles) and, with ``--variants``, copies of ``paged_decode.cu`` with the
design edits named in VARIANTS compile (``-Xptxas -v``, the flags of
``_build.py``) into their own libraries under
``flash_attn_tpu_torch/_build/k8_probe/`` and launch through ctypes:

  * registers, stack and spills of every K8 and K2 instance (ptxas);
  * K8 at chip_smoke.py's phase-2 points (B=8, H=32, Hk=8, D=128, 32 pages
    of 128 or 8 of 512 a sequence, lengths randint(1, 4096) with the first
    four 4096, 1, 1024, 0; bf16, int8, fp8, and fp8 pages holding only
    subnormal codes and zeros, so that a conversion that flushed them
    would fail) and at the paged engine's lengths (576-1056, fp8 and int8,
    pages of 128), each version's merged output
    against the plain version with the same splits: the share of the row
    tolerance (2^-6 of the row's largest |ref|) and the LSE error; the
    mutant must exceed the tolerance tenfold;
  * CUDA-graph times of a whole call (K8, plus K1m where the version merges
    outside the kernel) in turns (old..., this, this, ...old reversed),
    then the variants, beside chip_smoke.py's bound; and, as the design
    yardstick, this tree's chunk kernel taking the same decode call (K8c
    at T=1, R=4: its live splits, then K1m);
  * with ``--targets``, this tree's K8 and the variants at other values of
    ``ops/paged_decode.py:_TARGET_BLOCKS``; with ``--uniform``, both at
    uniform lengths (4096, 1024, 64; fp8, pages of 128) with 1-16 splits:
    what a tile and what a block cost;
  * K2 (fp8 and int8, B=8, Hk=8, S=4096, D=128) of every version against
    its plain version, and graph times in turns beside an empty kernel on
    K2's grid (this tree's ``fatt_empty``);
  * bitwise: K1 (BHSD), K1b (BSHD), K1c (T=5), K8c (T=128 over pages), K4
    (both softmax modes), K1m and K2 of every version against this tree's,
    and this tree's in-kernel merge against K1m on the same partials.

Every line goes to ``chiprun_out/k8_probe.txt`` and to stdout; the card's
name and power limit head it.  Exits nonzero if a check, the mutant's
failure or a bitwise comparison does not hold.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "chip_tools"))

import entry_args  # noqa: E402

P, I, F, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_int64
SIGS = {
    "fatt_paged_decode": [P] * 10 + [I] * 9 + [F, I, F, P],  # with split_len
    "fatt_paged_decode+live": [P] * 12 + [I] * 8 + [F, I, F, P],  # arrivals, in-kernel merge
    "fatt_decode": [P] * 9 + [I] * 9 + [F, F, I, F, P],
    "fatt_chunk_attn": [P] * 10 + [I] * 10 + [F, I, F, P],
    "fatt_flash_fwd": [P] * 7 + [I] * 7 + [F, I, I, P],
    "fatt_flash_fwd+masks": [P] * 12 + [I] * 7 + [F, I, I, P],  # tile metadata and count
    "fatt_lse_merge": [P, P, P, P, I, L, I, I, P],
    "fatt_kv_append": [P] * 7 + [I] * 5 + [P],
    "fatt_empty": [I, I, P],
}
SOURCES = ("paged_decode.cu", "lse_merge.cu", "kv_append.cu", "decode.cu", "chunk_attn.cu",
           "flash_fwd.cu")
# the mutant: split 1 walks no tiles, so its keys drop out of the merge
ANCHOR = "  const int n_tiles = max(0, min(per, n_live - t_lo));"
MUTANT = "  const int n_tiles = split == 1 ? 0 : max(0, min(per, n_live - t_lo));"
# the anchor of the "vsmem" variant: the 1-byte V branch of PV
VRAW = """    if constexpr (L::kRaw) {
      const uint4 va = chunk(vt, 2 * q4, g), vb = chunk(vt, 2 * q4 + 1, g);"""
VSMEM = """    if constexpr (L::kRaw) {
      uint4 raw[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) raw[i] = chunk(vt, (lane + 32 * i) >> 3, lane & 7);
      __syncwarp();
      unsigned char* bt = const_cast<unsigned char*>(st);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = (lane + 32 * i) >> 3, c = lane & 7;
        const uint32_t* w = reinterpret_cast<const uint32_t*>(&raw[i]);
        const uint4 lo = make_uint4(pair_bf16<KV, 0, 1>(w[0], w[0]), pair_bf16<KV, 2, 3>(w[0], w[0]),
                                    pair_bf16<KV, 0, 1>(w[1], w[1]), pair_bf16<KV, 2, 3>(w[1], w[1]));
        const uint4 hi = make_uint4(pair_bf16<KV, 0, 1>(w[2], w[2]), pair_bf16<KV, 2, 3>(w[2], w[2]),
                                    pair_bf16<KV, 0, 1>(w[3], w[3]), pair_bf16<KV, 2, 3>(w[3], w[3]));
        *reinterpret_cast<uint4*>(bt + r * 256 + (((2 * c) ^ (r & 7)) << 4)) = lo;
        *reinterpret_cast<uint4*>(bt + r * 256 + (((2 * c + 1) ^ (r & 7)) << 4)) = hi;
      }
      __syncwarp();
      const uint32_t bts = fatt::smem_u32(bt);
#pragma unroll
      for (int n = 0; n < kD / 8; n += 2) {
        const int r = (lane & 7) + 8 * ((lane >> 3) & 1), c = n + (lane >> 4);
        uint32_t f[4];
        asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\\n"
                     : "=r"(f[0]), "=r"(f[1]), "=r"(f[2]), "=r"(f[3])
                     : "r"(bts + r * 256 + ((c ^ (r & 7)) << 4)));
        mma16816(o[n], pf, f[0], f[1]);
        mma16816(o[n + 1], pf, f[2], f[3]);
      }
    } else if constexpr (false) {
      const uint4 va = chunk(vt, 2 * q4, g), vb = chunk(vt, 2 * q4 + 1, g);"""
# design edits of paged_decode.cu, timed beside this tree (--variants)
VARIANTS = {
    # the walk and the partials alone, no merge: what the merge costs
    "nomerge": (("  if (nsplit == 1) return;\n", "  return;\n"),),
    # one more ring stage for each KV type
    "stages+1": (("static constexpr int kStages = kRaw ? 3 : 2;",
                  "static constexpr int kStages = kRaw ? 4 : 3;"),),
    # two more ring stages for each 1-byte KV type, one more for bf16
    "stages+2": (("static constexpr int kStages = kRaw ? 3 : 2;",
                  "static constexpr int kStages = kRaw ? 5 : 3;"),),
    # no tiles at all: the fixed costs of a block (and the merge)
    "notiles": ((ANCHOR, "  const int n_tiles = 0;"),),
    # the ring's loads and waits without the products and the softmax
    "nocompute": (("    fatt::cp_async_commit();\n    const unsigned char* st = ring",
                   "    fatt::cp_async_commit();\n    if (p.B > 0) continue;\n"
                   "    const unsigned char* st = ring"),),
    # everything but O += P V (V's pairing and conversion included)
    "nopv": (("    // O += P V: B fragment n", "    if (p.B < 0)\n    // O += P V: B fragment n"),),
    # 1-byte V through shared memory: each warp converts its 16 V rows once
    # into a swizzled bf16 tile over the stage's K and V rows (K is read by
    # then) and reads PV's B fragments with ldmatrix.trans; O's columns
    # are then in order
    "vsmem": ((VRAW, VSMEM), ("  const int col = 16 * (tid % 8) + tid / 8;",
                              "  const int col = L::kRaw ? tid : 16 * (tid % 8) + tid / 8;")),
    # registers capped for four resident blocks an SM
    "minblocks4": (("__global__ void __launch_bounds__(kThreads) paged_decode_kernel",
                    "__global__ void __launch_bounds__(kThreads, 4) paged_decode_kernel"),),
}
OUT = ROOT / "chiprun_out" / "k8_probe.txt"
B, H, HK, D, S = 8, 32, 8, 128, 4096


def say(msg, fh):
    print(msg, flush=True)
    fh.write(msg + "\n")
    fh.flush()


def copy_edited(src: Path, dst: Path, *edits) -> Path:
    """A copy of ``src``'s K8 sources with paged_decode.cu edited: each edit
    an (anchor, replacement) pair whose anchor occurs once."""
    dst.mkdir(parents=True, exist_ok=True)
    for name in ("common.cuh", "paged_decode.cu", "lse_merge.cu"):
        shutil.copy(src / name, dst)
    text = (dst / "paged_decode.cu").read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"{dst.name}: anchor not found once: {old!r}")
        text = text.replace(old, new)
    (dst / "paged_decode.cu").write_text(text)
    return dst


def start_build(name, src_dir: Path, out_dir: Path):
    from flash_attn_tpu_torch import _build

    lib = out_dir / f"lib{name}.so"
    srcs = [str(src_dir / s) for s in SOURCES if (src_dir / s).exists()]
    cmd = [_build.nvcc_path(), *_build._ARCH, *_build._FLAGS, "-Xptxas", "-v", "-shared",
           "-I", str(src_dir), "-o", str(lib), *srcs]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return name, src_dir, lib, proc


class Lib:
    """One version's library and its entry points."""

    def __init__(self, job, fh):
        import ptxas_report

        name, src_dir, lib, proc = job
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{out}{err}")
        rows = ptxas_report.parse(err)
        for r, full in zip(rows, ptxas_report.demangle([r["name"] for r in rows])):
            if re.search(r"paged_decode|kv_append", full):
                say(f"[ptxas] {name}: regs {r['regs']:3d} stack {r.get('stack', 0):4d} spill "
                    f"st/ld {r.get('spill_st', 0)}/{r.get('spill_ld', 0)}  {full}", fh)
        self.name = name
        self.so = ctypes.CDLL(str(lib))
        text = (src_dir / "paged_decode.cu").read_text()
        head = text[text.index('extern "C" int fatt_paged_decode('):]
        self.live = "arrivals" in head[:head.index(")")]
        # a mutant's or a variant's copy holds K8's sources alone
        self.k4_masks = False
        if (src_dir / "flash_fwd.cu").exists():
            text = (src_dir / "flash_fwd.cu").read_text()
            head = text[text.index('extern "C" int fatt_flash_fwd('):]
            self.k4_masks = "qmeta" in head[:head.index(")")]
        self.fn = {}
        for entry in SIGS:
            base = entry.split("+")[0]
            if entry == "fatt_paged_decode" and self.live:
                continue
            if entry == "fatt_paged_decode+live" and not self.live:
                continue
            if entry.startswith("fatt_flash_fwd") and entry.endswith("+masks") != self.k4_masks:
                continue
            if not hasattr(self.so, base):
                continue
            src = src_dir / ("flash_fwd.cu" if base == "fatt_flash_fwd" else "decode.cu")
            self.fn[base] = entry_args.bind(getattr(self.so, base), src, base, SIGS[entry])

    def plan(self, case, target=None):
        """(nsplit, split_len) this version's wrapper would pick."""
        from flash_attn_tpu_torch.ops import decode as dec
        from flash_attn_tpu_torch.ops import paged_decode as pd

        if not self.live:  # splits of the table's reach
            return dec._splits(case.B, case.Hk, case.reach, None)
        base = pd._TARGET_BLOCKS
        pd._TARGET_BLOCKS = target or base
        try:
            return pd._plan(case.B, case.Hk, case.R, 1, case.reach, None)
        finally:
            pd._TARGET_BLOCKS = base

    def call(self, case, plan=None):
        """A whole decode call of this version on ``case``: returns a
        function giving (out [B, H, D] bf16, lse [B, H]); ``run.parts`` are
        the partials of the last run."""
        import torch

        nsplit, split_len = plan or self.plan(case)
        c = case
        out = torch.empty((c.B, c.H, D), dtype=torch.bfloat16, device="cuda")
        lse = torch.empty((c.B, c.H), dtype=torch.float32, device="cuda")
        part = torch.empty((nsplit, c.B, c.H, D), dtype=torch.float32, device="cuda")
        plse = torch.empty((nsplit, c.B, c.H), dtype=torch.float32, device="cuda")
        arrivals = torch.zeros((c.B * c.Hk,), dtype=torch.int32, device="cuda")
        p = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        st = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
        one = nsplit == 1
        head = (p(c.q), p(c.k), p(c.v), p(c.ks), p(c.vs), p(c.table), p(c.lens))
        fn = self.fn["fatt_paged_decode"]
        if self.live:
            args = (*head, p(out), p(lse), p(part), p(plse), p(arrivals), c.B, c.Hk, c.R,
                    c.page, c.mp, D, c.kv_type, nsplit, c.qscale, int(c.clamped), c.clamp2)
        else:
            args = (*head, p(out) if one else None, None if one else p(part), p(plse), c.B, c.Hk,
                    c.R, c.page, c.mp, D, c.kv_type, nsplit, split_len, c.qscale,
                    int(c.clamped), c.clamp2)
        merge = self.fn["fatt_lse_merge"]

        def run():
            rc = fn(*args, st())
            if rc != 0:
                raise RuntimeError(f"{self.name}: CUDA error {rc}")
            if one and not self.live:
                lse.copy_(plse[0])
            elif not self.live:
                rc = merge(p(part), p(plse), p(out), p(lse), nsplit, c.B * c.H, D, 0, st())
                if rc != 0:
                    raise RuntimeError(f"{self.name} K1m: CUDA error {rc}")
            return out, lse

        run.parts = (part, plse)
        return run


class Case:
    """One K8 point: inputs, the plain reference for a plan, the bound."""

    def __init__(self, torch, g, label, kv, page, lens=None, subnormal=False):
        from chip_smoke import _paged_inputs
        from flash_attn_tpu_torch.ops import decode as dec

        self.label, self.page = label, page
        self.q, self.k, self.v, self.ks, self.vs, self.table, self.lens = _paged_inputs(
            torch, kv, g, page)
        if subnormal:  # every stored e4m3 code a subnormal or zero, of either sign
            for t in (self.k, self.v):
                codes = torch.randint(0, 16, t.shape, generator=g, device="cuda",
                                      dtype=torch.uint8)
                t.view(torch.uint8).copy_((codes & 7) | ((codes & 8) << 4))
        if lens == "engine":
            self.lens = torch.randint(576, 1057, (B,), generator=g, device="cuda",
                                      dtype=torch.int32)
        self.B, self.H, self.Hk, self.R = B, H, HK, H // HK
        self.mp = self.table.shape[1]
        self.reach = self.mp * page
        mode = dec._default_softmax_mode(self.k.dtype)
        self.clamped = mode == "clamped"
        self.clamp2 = dec._clamp2(self.k.dtype)
        self.kv_type = dec._KV_TYPES[self.k.dtype]
        self.qscale = float(dec._qscale(D ** -0.5, self.clamped, torch.bfloat16))
        self.label += f" ({mode})"

    def ref(self, plan):
        from chip_smoke import plain_merge
        from flash_attn_tpu_torch.ops import paged_decode as pd

        import torch

        res = pd.paged_flash_decode_plain(self.q, self.k, self.v, self.ks, self.vs, self.table,
                                          self.lens, D ** -0.5, self.clamped, self.clamp2, 1,
                                          *plan)
        return plain_merge(*res, torch.bfloat16)

    def bound(self):
        from chip_smoke import bound

        import torch

        live = int(torch.clamp(self.lens.long(), 0, self.reach).sum())
        per_row = D * self.k.element_size() + (4 if self.ks is not None else 0)
        nbytes = (2 * self.Hk * live * per_row + 2 * self.q.numel() * 2 + self.B * 4
                  + self.table.numel() * 4)
        return bound(nbytes, 4 * D * self.H * live)

    def chunk_call(self, lib):
        """This tree's chunk kernel taking the same call (T=1, R=4, K8c's
        live splits), then K1m: the design yardstick."""
        import torch

        from flash_attn_tpu_torch.ops import decode as dec

        nsplit = dec._chunk_splits(self.B, self.Hk, self.R, self.reach, None)
        out = torch.empty((self.B, self.H, D), dtype=torch.bfloat16, device="cuda")
        lse = torch.empty((self.B, self.H), dtype=torch.float32, device="cuda")
        part = torch.empty((nsplit, self.B, self.H, D), dtype=torch.float32, device="cuda")
        plse = torch.empty((nsplit, self.B, self.H), dtype=torch.float32, device="cuda")
        p = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        st = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
        one = nsplit == 1

        def run():
            rc = lib.fn["fatt_chunk_attn"](
                p(self.q), p(self.k), p(self.v), p(self.ks), p(self.vs), p(self.table),
                p(self.lens), p(out) if one else None, None if one else p(part), p(plse),
                self.B, self.Hk, self.R, 1, 0, self.page, self.mp, D, self.kv_type, nsplit,
                self.qscale, int(self.clamped), self.clamp2, st())
            if rc != 0:
                raise RuntimeError(f"chunk kernel: CUDA error {rc}")
            if one:
                lse.copy_(plse[0])
            else:
                rc = lib.fn["fatt_lse_merge"](p(part), p(plse), p(out), p(lse), nsplit,
                                              self.B * self.H, D, 0, st())
                if rc != 0:
                    raise RuntimeError(f"K1m: CUDA error {rc}")
            return out, lse

        return run, nsplit


def points(torch, g):
    return [
        Case(torch, g, "K8 bf16 page=128", "bf16", 128),
        Case(torch, g, "K8 int8 page=128", "int8", 128),
        Case(torch, g, "K8 fp8 page=128", "fp8", 128),
        Case(torch, g, "K8 fp8 page=512", "fp8", 512),
        Case(torch, g, "K8 fp8 page=128 subnormal codes", "fp8", 128, subnormal=True),
        Case(torch, g, "K8 fp8 page=128 engine lengths", "fp8", 128, lens="engine"),
        Case(torch, g, "K8 int8 page=128 engine lengths", "int8", 128, lens="engine"),
    ]


def k2_inputs(torch, g, mode):
    dt = torch.int8 if mode == "int8" else torch.float8_e4m3fn
    if mode == "int8":
        kc = torch.randint(-127, 128, (B, HK, S, D), generator=g, device="cuda", dtype=dt)
    else:
        kc = torch.randn((B, HK, S, D), generator=g, device="cuda").to(dt)
    ks = torch.rand((B, HK, S), generator=g, device="cuda")
    nk = torch.randn((B, HK, D), generator=g, device="cuda", dtype=torch.bfloat16) * 3
    nv = torch.randn((B, HK, D), generator=g, device="cuda", dtype=torch.bfloat16)
    nk[0, 0] = 0  # an all-zero row: scale 1
    lens = torch.randint(0, S, (B,), generator=g, device="cuda", dtype=torch.int32)
    lens[0], lens[1] = S + 5, -1  # past the capacity and negative: nothing written
    return [kc, kc.clone(), ks, ks.clone()], nk, nv, lens


def k2(torch, libs, order, fh):
    """K2 of every version against the plain version (bit for bit) and
    against this tree's, then graph times in turns beside the empty
    kernel."""
    from chip_smoke import graph_ms
    from flash_attn_tpu_torch.ops import kv_append as ka

    g = torch.Generator(device="cuda").manual_seed(22)
    p = lambda t: t.data_ptr()  # noqa: E731
    st = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    ok = True
    for mode, code in (("int8", 1), ("fp8", 2)):
        bufs, nk, nv, lens = k2_inputs(torch, g, mode)
        want = [t.clone() for t in bufs]
        ka.kv_append_plain(*want, nk, nv, lens, mode)
        line = []
        for name, lib in libs.items():
            if name != "this" and not name.startswith("old:"):
                continue
            got = [t.clone() for t in bufs]
            rc = lib.fn["fatt_kv_append"](*(p(t) for t in got), p(nk), p(nv), p(lens), B, HK, S,
                                          D, code, st())
            torch.cuda.synchronize()
            if rc != 0:
                raise RuntimeError(f"{name} K2: CUDA error {rc}")
            same = all(torch.equal(a.view(torch.uint8) if a.element_size() == 1 else a,
                                   b.view(torch.uint8) if b.element_size() == 1 else b)
                       for a, b in zip(got, want))
            ok &= same
            line.append(f"{name} {'bitwise' if same else 'DIFFERS'}")
        say(f"[check] K2 {mode} against its plain version: " + ", ".join(line), fh)

        def launch(lib, bufs=bufs):
            rc = lib.fn["fatt_kv_append"](*(p(t) for t in bufs), p(nk), p(nv), p(lens), B, HK,
                                          S, D, code, st())
            if rc != 0:
                raise RuntimeError(f"K2: CUDA error {rc}")

        times = [f"{name} {graph_ms(torch, lambda lib=libs[name]: launch(lib)):.5f}"
                 for name in order]
        empty = libs["this"].fn["fatt_empty"]
        e_ms = graph_ms(torch, lambda: empty(B, HK, st()))
        say(f"[turn] K2 {mode}: graph ms " + " / ".join(times)
            + f" | empty kernel on K2's grid {e_ms:.5f}", fh)
    return ok


def bitwise(torch, libs, fh):
    """K1 (BHSD, BSHD), K1c, K8c, K4, K1m of every version against this
    tree's, bit for bit; and this tree's in-kernel merge against K1m on the
    same partials."""
    from chip_smoke import _decode_inputs, _paged_inputs
    from flash_attn_tpu_torch.ops import decode as dec
    from flash_attn_tpu_torch.ops import flash_fwd as ff
    from flash_attn_tpu_torch.ops.rope import rope_cos_sin

    g = torch.Generator(device="cuda").manual_seed(5)
    st = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    p = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    q, k, v, ks, vs, lens = _decode_inputs(torch, "fp8", g)
    kb, vb = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    ksb, vsb = ks.transpose(1, 2).contiguous(), vs.transpose(1, 2).contiguous()
    nsplit, split_len = dec._splits(B, HK, S, None)
    qs_c = float(dec._qscale(D ** -0.5, True, torch.bfloat16))
    T = 5
    qc = torch.randn((B, HK * T * 4, D), generator=g, device="cuda", dtype=torch.bfloat16)
    lens_c = torch.clamp(lens, min=T)
    nsplit_c = dec._chunk_splits(B, HK, T * 4, S, None)
    _, kp, vp, ksp, vsp, table, _ = _paged_inputs(torch, "fp8", g, 128, B=1)
    q8c = torch.randn((1, HK * 128 * 4, D), generator=g, device="cuda", dtype=torch.bfloat16)
    lens8c = torch.tensor([640], dtype=torch.int32, device="cuda")
    nsplit_8c = dec._chunk_splits(1, HK, 512, S, None)
    cos, sin = rope_cos_sin(torch.arange(2048, device="cuda")[None], D, 500000.0)
    qf = torch.randn((1, 2048, H, D), generator=g, device="cuda", dtype=torch.bfloat16)
    kf = torch.randn((1, 2048, HK, D), generator=g, device="cuda", dtype=torch.bfloat16)
    vf = torch.randn((1, 2048, HK, D), generator=g, device="cuda", dtype=torch.bfloat16)
    eff = float(D ** -0.5 * ff.LOG2E)
    part_m = torch.randn((13, B * H, D), generator=g, device="cuda")
    lse_m = torch.randn((13, B * H), generator=g, device="cuda") * 4
    lse_m[1, ::4] = float("-inf")
    lse_m[2:, 7] = -1e30

    def run(lib, what):
        fn = lib.fn
        if what in ("K1", "K1b"):
            bshd = what == "K1b"
            part = torch.empty((nsplit, B, H, D), dtype=torch.float32, device="cuda")
            plse = torch.empty((nsplit, B, H), dtype=torch.float32, device="cuda")
            cache = (kb, vb, ksb, vsb) if bshd else (k, v, ks, vs)
            rc = fn["fatt_decode"](p(q), *(p(t) for t in cache), p(lens), None, p(part), p(plse),
                                   B, HK, H // HK, S, D, int(bshd), 2, nsplit, split_len,
                                   1.0 if bshd else qs_c, D ** -0.5 if bshd else 1.0,
                                   int(not bshd), 40.0, st())
            res = (part, plse)
        elif what in ("K1c", "K8c"):
            chunk = what == "K1c"
            n = nsplit_c if chunk else nsplit_8c
            qq = qc if chunk else q8c
            bb = B if chunk else 1
            part = torch.empty((n,) + qq.shape, dtype=torch.float32, device="cuda")
            plse = torch.empty((n,) + qq.shape[:2], dtype=torch.float32, device="cuda")
            if chunk:
                args = (p(qq), p(k), p(v), p(ks), p(vs), None, p(lens_c), None, p(part), p(plse),
                        B, HK, T * 4, T, S, 0, 0)
            else:
                args = (p(qq), p(kp), p(vp), p(ksp), p(vsp), p(table), p(lens8c), None, p(part),
                        p(plse), bb, HK, 512, 128, 0, 128, table.shape[1])
            rc = fn["fatt_chunk_attn"](*args, D, 2, n, qs_c, 1, 40.0, st())
            res = (part, plse)
        elif what == "K1m":
            out = torch.empty((B * H, D), dtype=torch.bfloat16, device="cuda")
            lse = torch.empty((B * H,), dtype=torch.float32, device="cuda")
            rc = fn["fatt_lse_merge"](p(part_m), p(lse_m), p(out), p(lse), 13, B * H, D, 0, st())
            res = (out, lse)
        else:
            out = torch.empty_like(qf)
            flse = torch.empty((1, H, 2048), dtype=torch.float32, device="cuda")
            rc = fn["fatt_flash_fwd"](p(qf), p(kf), p(vf), p(cos), p(sin), p(out), p(flse),
                                      *(None,) * (5 * lib.k4_masks), 1, 2048, 2048, H, HK, D,
                                      0, eff, 1, int(what == "K4 clamped"), st())
            res = (out, flse)
        torch.cuda.synchronize()
        if rc != 0:
            raise RuntimeError(f"{lib.name} {what}: CUDA error {rc}")
        return res

    ok = True
    for what in ("K1", "K1b", "K1c", "K8c", "K4 clamped", "K4 online", "K1m"):
        want = run(libs["this"], what)
        line = []
        for name, lib in libs.items():
            if not name.startswith("old:"):
                continue
            same = all(torch.equal(a, b) for a, b in zip(run(lib, what), want))
            ok &= same
            line.append(f"{name[4:]} {'bitwise' if same else 'DIFFERS'}")
        say(f"[bitwise] {what}: " + ", ".join(line), fh)
    return ok


def merge_bitwise(torch, lib, case, fh):
    """This tree's in-kernel merge against K1m (this tree's) on the same
    partials, bit for bit."""
    run = lib.call(case)
    out, lse = run()
    part, plse = run.parts
    o2 = torch.empty_like(out)
    l2 = torch.empty_like(lse)
    st = torch.cuda.current_stream().cuda_stream
    rc = lib.fn["fatt_lse_merge"](part.data_ptr(), plse.data_ptr(), o2.data_ptr(), l2.data_ptr(),
                                  part.shape[0], case.B * case.H, D, 0, st)
    torch.cuda.synchronize()
    if rc != 0:
        raise RuntimeError(f"K1m: CUDA error {rc}")
    same = torch.equal(out, o2) and torch.equal(lse, l2)
    say(f"[bitwise] in-kernel merge against K1m on the same partials, {case.label}, "
        f"{part.shape[0]} splits: {'bitwise' if same else 'DIFFERS'}", fh)
    return same


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", action="append", default=[], help="NAME=DIR of an earlier csrc")
    ap.add_argument("--targets", default="", help="other _TARGET_BLOCKS to time")
    ap.add_argument("--variants", default="", help=f"design edits to time: {list(VARIANTS)}")
    ap.add_argument("--uniform", action="store_true",
                    help="also time uniform lengths at fixed split counts")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("k8_probe: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import graph_ms, row_err

    OUT.parent.mkdir(parents=True, exist_ok=True)
    fh = OUT.open("w")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    say(f"card: {smi} | torch {torch.__version__}", fh)
    out_dir = ROOT / "flash_attn_tpu_torch" / "_build" / "k8_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    this = ROOT / "flash_attn_tpu_torch" / "csrc"
    olds = [tuple(o.split("=", 1)) for o in args.old]
    variants = [v for v in args.variants.split(",") if v]
    jobs = [(f"old:{n}", Path(d)) for n, d in olds] + [("this", this)]
    jobs.append(("mutant", copy_edited(this, out_dir / "mutant_src", (ANCHOR, MUTANT))))
    jobs += [(v, copy_edited(this, out_dir / f"{v}_src", *VARIANTS[v])) for v in variants]
    started = [(start_build(re.sub(r"\W", "_", name), src, out_dir), name) for name, src in jobs]
    libs = {}
    for job, name in started:
        libs[name] = Lib(job, fh)
        libs[name].name = name
    gen = torch.Generator(device="cuda").manual_seed(15)
    cases = points(torch, gen)
    ok = True
    for case in cases:
        line = []
        for name, lib in libs.items():
            plan = lib.plan(case)
            got, glse = lib.call(case, plan)()
            ref, rlse = case.ref(plan)
            torch.cuda.synchronize()
            _, share = row_err(got, ref)
            live = case.lens > 0
            lerr = float((glse - rlse)[live].abs().max())
            empty = bool((got[~live] == 0).all() and (glse[~live] <= -1e29).all())
            if name == "mutant":
                good = share >= 10.0
            elif name in variants:
                good = True  # timed, not checked (nomerge writes no output)
            else:
                good = share <= 1.0 and lerr <= 1e-3 and empty
            ok &= good
            line.append(f"{name} {share:.3f}/{lerr:.1e} ({plan[0]} splits)"
                        f"{'' if good else ' FAIL'}")
        chunk_run, n_c = case.chunk_call(libs["this"])
        got, glse = chunk_run()
        ref, rlse = case.ref((n_c, None))
        torch.cuda.synchronize()
        _, share = row_err(got, ref)
        line.append(f"K8c at T=1 {share:.3f} ({n_c} splits)")
        say(f"[check] {case.label} lengths {case.lens.tolist()}: share of the row tolerance / "
            "lse err: " + ", ".join(line) + " (the mutant must reach 10)", fh)
    ok &= merge_bitwise(torch, libs["this"], cases[2], fh)
    ok &= merge_bitwise(torch, libs["this"], cases[5], fh)
    order = [f"old:{n}" for n, _ in olds] + ["this", "this"] + [f"old:{n}" for n, _ in
                                                                 reversed(olds)]
    for case in cases:
        b_ms, b_by = case.bound()
        times = [f"{name} {graph_ms(torch, libs[name].call(case)):.4f}" for name in order]
        times += [f"{v} {graph_ms(torch, libs[v].call(case)):.4f}" for v in variants]
        times.append(f"K8c at T=1 {graph_ms(torch, case.chunk_call(libs['this'])[0]):.4f}")
        say(f"[turn] {case.label}: graph ms (whole call) " + " / ".join(times)
            + f" | bound {b_ms:.4f} ({b_by})", fh)
    for target in [int(t) for t in args.targets.split(",") if t]:
        for name in ["this"] + variants:
            line = []
            for case in cases:
                plan = libs[name].plan(case, target)
                line.append(f"{case.label} {graph_ms(torch, libs[name].call(case, plan)):.4f} "
                            f"({plan[0]})")
            say(f"[target {target}] {name}: graph ms (splits): " + ", ".join(line), fh)
    if args.uniform:  # every sequence at one length: the cost of a tile and of a block
        case = Case(torch, gen, "uniform", "fp8", 128)
        for length in (4096, 1024, 64):
            case.lens.fill_(length)
            for n in (1, 2, 4, 8, 16):
                times = [f"{name} {graph_ms(torch, libs[name].call(case, (n, None))):.4f}"
                         for name in ["this"] + variants]
                say(f"[uniform] fp8 page=128 kv_len {length}, {n} splits ({n * B * HK} blocks): "
                    "graph ms " + " / ".join(times), fh)
    ok &= k2(torch, libs, order, fh)
    ok &= bitwise(torch, libs, fh)
    say(f"[done] {'all checks hold' if ok else 'A CHECK FAILED'}", fh)
    shutil.rmtree(out_dir, ignore_errors=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
