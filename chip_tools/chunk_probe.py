#!/usr/bin/env python3
"""The chunk kernel (K1c, K8c: csrc/chunk_attn.cu) against the chunk
instances it replaced: registers, errors, times, a mutant that must fail,
and the decode kernels and K4 held bitwise.

    python3 chip_tools/chunk_probe.py --old NAME=DIR [--old NAME=DIR ...]
                                      [--targets 66,132,264,528] [--wide 1,3]

Each DIR holds an earlier tree's ``decode.cu``, ``paged_decode.cu``,
``flash_fwd.cu`` and the ``common.cuh`` they include, for example the
parent's ``flash_attn_tpu_torch/csrc`` unpacked by ``git archive``; a
version without ``chunk_attn.cu`` runs chunk mode on those kernels with
its own split plan (split lengths on the capacity or the table's reach,
repeated here).  Each version, this tree's sources, a mutant of
``chunk_attn.cu`` (split 1 walks no tiles) and, with ``--wide``, copies
with other warpgroup counts above 64 rows (``kWideW``) compile
(``-Xptxas -v``, the flags of ``_build.py``) into their own libraries
under ``flash_attn_tpu_torch/_build/chunk_probe/`` and launch through
ctypes:

  * registers, stack and spills of every kernel instance (ptxas);
  * at every K1c and K8c point of chip_smoke.py's phase 2 (K1c at T=5,
    B=8, S=4096: bf16, int8, fp8 at H=32, fp8 at H=64, fp8 at the verify
    step's lengths 142-923 at H=32 and H=24; a BHSD decode at G=16; K8c
    at B=1 over pages of 128: T=128 at kv_len 640 in three KV types and
    1024 in fp8, a ragged T=123 at 1019, T=4 at 700 in int8 in both
    softmax modes), each version's output merged by K1m against the plain
    version with the same splits: the share of the row tolerance (2^-6 of
    the row's largest |ref|) and the LSE error; the mutant must exceed the
    tolerance tenfold wherever it has two or more splits;
  * CUDA-graph times of kernel + merge in turns (old..., this, this,
    ...old reversed), then the --wide copies, beside the bound of
    chip_smoke.py;
  * with ``--targets``, this tree's times at other values of
    ``ops/decode.py:_CHUNK_TARGET_WARPGROUPS``;
  * how far each version's verify step lies from its own decode steps
    (the self-draft's case: bf16 cache, online softmax, T=5 at the verify
    step's lengths; row t against a one-token decode at kv_len - 4 + t,
    both merged by K1m): reported, not checked;
  * K1 decode (BHSD and BSHD) and K4 (both softmax modes) of every
    version against this tree's, bit for bit (K8 decode, redesigned since,
    is held by chip_tools/k8_probe.py).

Every line goes to ``chiprun_out/chunk_probe.txt`` and to stdout; the
card's name and power limit head it.  Exits nonzero if a check, the
mutant's failure or a bitwise comparison does not hold.
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

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGS = {
    "fatt_decode": [P] * 9 + [I] * 9 + [F, F, I, F, P],
    "fatt_decode+chunk": [P] * 9 + [I] * 10 + [F, F, I, F, P],
    "fatt_paged_decode": [P] * 10 + [I] * 9 + [F, I, F, P],
    "fatt_paged_decode+chunk": [P] * 10 + [I] * 10 + [F, I, F, P],
    "fatt_chunk_attn": [P] * 10 + [I] * 10 + [F, I, F, P],
    "fatt_flash_fwd": [P] * 7 + [I] * 7 + [F, I, I, P],
    "fatt_flash_fwd+masks": [P] * 12 + [I] * 7 + [F, I, I, P],  # tile metadata and count
}
SOURCES = ("chunk_attn.cu", "decode.cu", "paged_decode.cu", "flash_fwd.cu")
# the mutant: split 1 walks no tiles, so its keys drop out of the merge
ANCHOR = "  const int n_tiles =\n      max(0, min("
MUTANT = "  const int n_tiles =\n      split == 1 ? 0 : max(0, min("
WIDE = "constexpr int kWideW = 2;"
OUT = ROOT / "chiprun_out" / "chunk_probe.txt"
D = 128


def say(msg, fh):
    print(msg, flush=True)
    fh.write(msg + "\n")
    fh.flush()


def copy_edited(src: Path, dst: Path, old: str, new: str) -> Path:
    dst.mkdir(parents=True, exist_ok=True)
    for name in ("common.cuh", *SOURCES):
        shutil.copy(src / name, dst)
    text = (dst / "chunk_attn.cu").read_text()
    if text.count(old) != 1:
        raise RuntimeError(f"{dst.name}: anchor not found once: {old!r}")
    (dst / "chunk_attn.cu").write_text(text.replace(old, new))
    return dst


def start_build(name, src_dir: Path, out_dir: Path):
    from flash_attn_tpu_torch import _build

    lib = out_dir / f"lib{name}.so"
    srcs = [str(src_dir / s) for s in SOURCES if (src_dir / s).exists()]
    cmd = [_build.nvcc_path(), *_build._ARCH, *_build._FLAGS, "-Xptxas", "-v", "-shared",
           "-I", str(src_dir), "-o", str(lib), *srcs]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return name, src_dir, lib, proc


def takes_chunk(src: Path, entry: str, arg: str = "int chunk") -> bool:
    """Whether the C entry point ``entry`` of ``src`` has a chunk argument
    (or another ``arg``)."""
    text = src.read_text()
    head = text[text.index(f'extern "C" int {entry}('):]
    return arg in head[:head.index(")")]


class Lib:
    """One version's library: its entry points and its split plans."""

    def __init__(self, job, fh, wide=2):
        import ptxas_report

        name, src_dir, lib, proc = job
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{out}{err}")
        rows = ptxas_report.parse(err)
        for r, full in zip(rows, ptxas_report.demangle([r["name"] for r in rows])):
            if re.search(r"chunk_attn|decode_kernel|flash_fwd", full):
                say(f"[ptxas] {name}: regs {r['regs']:3d} stack {r.get('stack', 0):4d} spill "
                    f"st/ld {r.get('spill_st', 0)}/{r.get('spill_ld', 0)}  {full}", fh)
        self.name, self.wide = name, wide
        self.so = ctypes.CDLL(str(lib))
        self.chunk = hasattr(self.so, "fatt_chunk_attn")
        self.fn = {}
        for entry, src in (("fatt_decode", "decode.cu"), ("fatt_paged_decode", "paged_decode.cu"),
                           ("fatt_chunk_attn", "chunk_attn.cu"), ("fatt_flash_fwd", "flash_fwd.cu")):
            if not hasattr(self.so, entry):
                continue
            if entry == "fatt_flash_fwd":
                sig = entry + ("+masks" if takes_chunk(src_dir / src, entry, "qmeta") else "")
            else:
                sig = entry + ("+chunk" if entry != "fatt_chunk_attn"
                               and takes_chunk(src_dir / src, entry) else "")
            fn = entry_args.bind(getattr(self.so, entry), src_dir / src, entry, SIGS[sig])
            self.fn[entry] = (fn, sig.endswith(("+chunk", "+masks")))

    def plan(self, case):
        """(nsplit, split_len) this version's wrapper would pick."""
        from flash_attn_tpu_torch.ops import decode as dec

        if self.chunk:
            base = dec.CHUNK_WIDE
            dec.CHUNK_WIDE = self.wide
            try:
                return dec._chunk_splits(case.B, case.Hk, case.R, case.cap, None), None
            finally:
                dec.CHUNK_WIDE = base
        if case.paged:  # the parent's K8: rows in tiles of 16 (decode) or 64 (chunk)
            tiles = -(-case.R // (16 if case.R <= 16 else 64))
            return dec._splits(case.B * tiles, case.Hk, case.cap, None,
                               None if case.T == 1 else 264)
        return dec._splits(case.B * -(-case.R // 8), case.Hk, case.cap, None)

    def call(self, case, plan=None):
        """A launch of this version's kernel on ``case`` (K1m merging its
        partials): returns a function giving (out [B, Hk * R, D] bf16, lse)."""
        import torch

        from flash_attn_tpu_torch.ops.lse import lse_merge_cuda

        nsplit, split_len = plan or self.plan(case)
        out = torch.empty((case.B, case.Hk * case.R, D), dtype=torch.bfloat16, device="cuda")
        part = torch.empty((nsplit,) + out.shape, dtype=torch.float32, device="cuda")
        lse = torch.empty((nsplit, case.B, case.Hk * case.R), dtype=torch.float32,
                          device="cuda")
        one = nsplit == 1
        p = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        c = case
        ptrs = (p(c.q2), p(c.k), p(c.v), p(c.ks), p(c.vs))
        tail = (p(out) if one else None, None if one else p(part), p(lse))
        st = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
        if self.chunk and (c.T > 1 or c.R > (16 if c.paged else 8)):
            fn, _ = self.fn["fatt_chunk_attn"]
            args = (*ptrs, p(c.table), p(c.lens), *tail, c.B, c.Hk, c.R, c.T,
                    0 if c.paged else c.cap, c.page, c.mp, D, c.kv_type, nsplit, c.qscale,
                    int(c.clamped), c.clamp2)
        elif c.paged:
            fn, chunk = self.fn["fatt_paged_decode"]
            args = (*ptrs, p(c.table), p(c.lens), *tail, c.B, c.Hk, c.R, *((c.T,) if chunk else ()),
                    c.page, c.mp, D, c.kv_type, nsplit, split_len, c.qscale, int(c.clamped),
                    c.clamp2)
        else:
            fn, chunk = self.fn["fatt_decode"]
            args = (*ptrs, p(c.lens), *tail, c.B, c.Hk, c.R, *((c.T,) if chunk else ()), c.cap,
                    D, 0, c.kv_type, nsplit, split_len, c.qscale, 1.0, int(c.clamped), c.clamp2)

        def run():
            rc = fn(*args, st())
            if rc != 0:
                raise RuntimeError(f"{self.name}: CUDA error {rc}")
            if one:
                return out, lse[0]
            return lse_merge_cuda(part, lse, torch.bfloat16)

        run.keep = (out, part, lse)
        return run


class Case:
    """One point: inputs, the plain reference for a plan, the bound."""

    def __init__(self, torch, g, label, kv, H, T, *, paged=False, kv_len=None, lens=None,
                 mode=None):
        from chip_smoke import _decode_inputs, _paged_inputs
        from flash_attn_tpu_torch.ops import decode as dec

        self.label, self.paged, self.T = label, paged, T
        self.B, self.Hk, S = (1 if paged else 8), 8, 4096
        if paged:
            _, self.k, self.v, self.ks, self.vs, self.table, _ = _paged_inputs(
                torch, kv, g, 128, B=1)
            self.page, self.mp = 128, self.table.shape[1]
            self.lens = torch.tensor([kv_len], dtype=torch.int32, device="cuda")
        else:
            _, self.k, self.v, self.ks, self.vs, _ = _decode_inputs(torch, kv, g, H=H)
            self.table, self.page, self.mp = None, 0, 0
            if lens == "verify":
                self.lens = torch.randint(142, 924, (self.B,), generator=g, device="cuda",
                                          dtype=torch.int32)
            else:
                self.lens = torch.randint(T, S + 1, (self.B,), generator=g, device="cuda",
                                          dtype=torch.int32)
                self.lens[0], self.lens[1], self.lens[2] = S, T, S + 7
        self.cap = S
        G = H // self.Hk
        self.R = T * G
        q = torch.randn((self.B, T, H, D), generator=g, device="cuda", dtype=torch.bfloat16)
        self.q2 = (q.reshape(self.B, T, self.Hk, G, D).transpose(1, 2)
                   .reshape(self.B, self.Hk * self.R, D).contiguous())
        mode = mode or dec._default_softmax_mode(self.k.dtype)
        self.clamped = mode == "clamped"
        self.clamp2 = dec._clamp2(self.k.dtype)
        self.kv_type = dec._KV_TYPES[self.k.dtype]
        self.qscale = float(dec._qscale(D ** -0.5, self.clamped, torch.bfloat16))
        self.label += f" ({mode})"

    def ref(self, plan):
        from chip_smoke import plain_merge
        from flash_attn_tpu_torch.ops import decode as dec
        from flash_attn_tpu_torch.ops import paged_decode as pd

        import torch

        nsplit, split_len = plan
        if self.paged:
            res = pd.paged_flash_decode_plain(
                self.q2, self.k, self.v, self.ks, self.vs, self.table, self.lens, D ** -0.5,
                self.clamped, self.clamp2, self.T, nsplit, split_len)
        else:
            res = dec.flash_decode_plain(self.q2, self.k, self.v, self.ks, self.vs, self.lens,
                                         D ** -0.5, self.clamped, self.clamp2, nsplit,
                                         split_len, self.T)
        return plain_merge(*res, torch.bfloat16)

    def bound(self):
        """chip_smoke.py's bound: each live K/V row and scale once, q and
        out once, 4 D flops per visible (row, key) pair."""
        from chip_smoke import bound

        import torch

        G = self.R // self.T
        lim = torch.clamp(self.lens.long()[:, None] - (self.T - 1)
                          + torch.arange(self.R, device="cuda")[None] // G, 0, self.cap)
        live = int(torch.clamp(self.lens.long(), 0, self.cap).sum())
        per_row = D * self.k.element_size() + (4 if self.ks is not None else 0)
        nbytes = 2 * self.Hk * live * per_row + 2 * self.q2.numel() * 2 + self.B * 4
        return bound(nbytes, 4 * D * self.Hk * int(lim.sum()))


def points(torch, g):
    return [
        Case(torch, g, "K1c bf16 H=32 T=5", "bf16", 32, 5),
        Case(torch, g, "K1c int8 H=32 T=5", "int8", 32, 5),
        Case(torch, g, "K1c fp8 H=32 T=5", "fp8", 32, 5),
        Case(torch, g, "K1c fp8 H=64 T=5", "fp8", 64, 5),
        Case(torch, g, "K1c fp8 H=32 T=5 verify lengths", "fp8", 32, 5, lens="verify"),
        Case(torch, g, "K1c fp8 H=24 T=5 verify lengths", "fp8", 24, 5, lens="verify"),
        Case(torch, g, "K1c fp8 decode G=16", "fp8", 128, 1),
        Case(torch, g, "K8c bf16 T=128 kv_len=640", "bf16", 32, 128, paged=True, kv_len=640),
        Case(torch, g, "K8c int8 T=128 kv_len=640", "int8", 32, 128, paged=True, kv_len=640),
        Case(torch, g, "K8c fp8 T=128 kv_len=640", "fp8", 32, 128, paged=True, kv_len=640),
        Case(torch, g, "K8c fp8 T=128 kv_len=1024", "fp8", 32, 128, paged=True, kv_len=1024),
        Case(torch, g, "K8c fp8 T=123 kv_len=1019", "fp8", 32, 123, paged=True, kv_len=1019),
        Case(torch, g, "K8c int8 T=4 kv_len=700", "int8", 32, 4, paged=True, kv_len=700),
        Case(torch, g, "K8c int8 T=4 kv_len=700", "int8", 32, 4, paged=True, kv_len=700,
             mode="clamped"),
    ]


def verify_vs_decode(torch, libs, fh):
    """Row t of each version's T=5 chunk against that version's K1 decode
    at kv_len - 4 + t, on a bf16 cache in online softmax (the self-draft's
    verify step and draft steps): the worst share of the row tolerance, the
    mean |difference| and the share of rows that differ at all."""
    from chip_smoke import row_err
    from flash_attn_tpu_torch.ops import decode as dec
    from flash_attn_tpu_torch.ops.lse import lse_merge_cuda

    c = Case(torch, torch.Generator(device="cuda").manual_seed(9), "verify vs decode", "bf16",
             32, 5, lens="verify")
    B, Hk, T, S = c.B, c.Hk, c.T, c.cap
    G = c.R // T
    nsplit, split_len = dec._splits(B, Hk, S, None)
    st = torch.cuda.current_stream().cuda_stream
    for name, lib in libs.items():
        if name != "this" and not name.startswith("old:"):
            continue
        got, _ = lib.call(c)()
        got = got.reshape(B, Hk, T, G, D).transpose(1, 2).reshape(B, T, Hk * G, D)
        fn, chunk = lib.fn["fatt_decode"]
        outs = []
        for t in range(T):
            q_t = c.q2.reshape(B, Hk, T, G, D)[:, :, t].reshape(B, Hk * G, D).contiguous()
            lens_t = (c.lens - (T - 1) + t).contiguous()
            part = torch.empty((nsplit, B, Hk * G, D), dtype=torch.float32, device="cuda")
            lse = torch.empty((nsplit, B, Hk * G), dtype=torch.float32, device="cuda")
            rc = fn(q_t.data_ptr(), c.k.data_ptr(), c.v.data_ptr(), None, None, lens_t.data_ptr(),
                    None, part.data_ptr(), lse.data_ptr(), B, Hk, G, *((1,) if chunk else ()), S,
                    D, 0, 0, nsplit, split_len, c.qscale, 1.0, 0, c.clamp2, st)
            if rc != 0:
                raise RuntimeError(f"{name} decode: CUDA error {rc}")
            outs.append(lse_merge_cuda(part, lse, torch.bfloat16)[0])
        want = torch.stack(outs, 1)
        _, share = row_err(got, want)
        diff = (got.float() - want.float()).abs()
        say(f"[verify vs decode] {name}: worst share of the row tolerance {share:.3f}, mean "
            f"|diff| {float(diff.mean()):.3e}, rows that differ "
            f"{float((diff.amax(-1) > 0).float().mean()):.3f}", fh)


def bitwise(torch, libs, fh):
    """K1 decode (BHSD, BSHD) and K4 of every version against this tree's,
    bit for bit."""
    from chip_smoke import _decode_inputs
    from flash_attn_tpu_torch.ops import decode as dec
    from flash_attn_tpu_torch.ops import flash_fwd as ff
    from flash_attn_tpu_torch.ops.rope import rope_cos_sin

    g = torch.Generator(device="cuda").manual_seed(5)
    st = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    p = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    B, H, Hk, S = 8, 32, 8, 4096
    q, k, v, ks, vs, lens = _decode_inputs(torch, "fp8", g)
    kb, vb = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    ksb, vsb = ks.transpose(1, 2).contiguous(), vs.transpose(1, 2).contiguous()
    nsplit, split_len = dec._splits(B, Hk, S, None)
    qs_c = float(dec._qscale(D ** -0.5, True, torch.bfloat16))
    cos, sin = rope_cos_sin(torch.arange(2048, device="cuda")[None], D, 500000.0)
    qf = torch.randn((1, 2048, H, D), generator=g, device="cuda", dtype=torch.bfloat16)
    kf = torch.randn((1, 2048, Hk, D), generator=g, device="cuda", dtype=torch.bfloat16)
    vf = torch.randn((1, 2048, Hk, D), generator=g, device="cuda", dtype=torch.bfloat16)
    eff = float(D ** -0.5 * ff.LOG2E)

    def run(lib, what):
        part = torch.empty((nsplit, B, H, D), dtype=torch.float32, device="cuda")
        lse = torch.empty((nsplit, B, H), dtype=torch.float32, device="cuda")
        if what in ("K1 BHSD", "K1 BSHD"):
            fn, chunk = lib.fn["fatt_decode"]
            bshd = what == "K1 BSHD"
            cache = (kb, vb, ksb, vsb) if bshd else (k, v, ks, vs)
            rc = fn(p(q), *(p(t) for t in cache), p(lens), None, p(part), p(lse), B, Hk, H // Hk,
                    *((1,) if chunk else ()), S, D, int(bshd), 2, nsplit, split_len,
                    1.0 if bshd else qs_c, D ** -0.5 if bshd else 1.0, int(not bshd), 40.0, st())
            res = (part, lse)
        else:
            fn, masks = lib.fn["fatt_flash_fwd"]
            out = torch.empty_like(qf)
            flse = torch.empty((1, H, 2048), dtype=torch.float32, device="cuda")
            clamped = what == "K4 clamped"
            rc = fn(p(qf), p(kf), p(vf), p(cos), p(sin), p(out), p(flse), *(None,) * (5 * masks),
                    1, 2048, 2048, H, Hk, D, 0, eff, 1, int(clamped), st())
            res = (out, flse)
        torch.cuda.synchronize()
        if rc != 0:
            raise RuntimeError(f"{lib.name} {what}: CUDA error {rc}")
        return res

    ok = True
    for what in ("K1 BHSD", "K1 BSHD", "K4 clamped", "K4 online"):
        want = run(libs["this"], what)
        line = []
        for name, lib in libs.items():
            if name == "this" or not name.startswith("old:"):
                continue
            got = run(lib, what)
            same = all(torch.equal(a, b) for a, b in zip(got, want))
            ok &= same
            line.append(f"{name[4:]} {'bitwise' if same else 'DIFFERS'}")
        say(f"[bitwise] {what}: " + ", ".join(line), fh)
    return ok


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", action="append", default=[], help="NAME=DIR of an earlier csrc")
    ap.add_argument("--targets", default="", help="other _CHUNK_TARGET_WARPGROUPS to time")
    ap.add_argument("--wide", default="", help="other kWideW values to build and time")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chunk_probe: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import graph_ms, row_err
    from flash_attn_tpu_torch.ops import decode as dec

    OUT.parent.mkdir(parents=True, exist_ok=True)
    fh = OUT.open("w")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    say(f"card: {smi} | torch {torch.__version__}", fh)
    out_dir = ROOT / "flash_attn_tpu_torch" / "_build" / "chunk_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    this = ROOT / "flash_attn_tpu_torch" / "csrc"
    olds = [tuple(o.split("=", 1)) for o in args.old]
    wides = [int(w) for w in args.wide.split(",") if w]
    jobs = [(f"old:{n}", Path(d), 2) for n, d in olds] + [("this", this, 2)]
    jobs.append(("mutant", copy_edited(this, out_dir / "mutant_src", ANCHOR, MUTANT), 2))
    jobs += [(f"wide{w}", copy_edited(this, out_dir / f"wide{w}_src", WIDE,
                                      f"constexpr int kWideW = {w};"), w) for w in wides]
    started = [(start_build(name.replace(":", "_"), src, out_dir), name, w)
               for name, src, w in jobs]
    libs = {}
    for job, name, w in started:
        libs[name] = Lib(job, fh, wide=w)
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
            lerr = float((glse - rlse).abs().max())
            if name == "mutant":
                good = share >= 10.0 or plan[0] < 2
            else:
                good = share <= 1.0 and lerr <= 1e-3
            ok &= good
            line.append(f"{name} {share:.3f}/{lerr:.1e} ({plan[0]} splits)"
                        f"{'' if good else ' FAIL'}")
        say(f"[check] {case.label}: share of the row tolerance / lse err: " + ", ".join(line)
            + " (the mutant must reach 10)", fh)
    order = ([f"old:{n}" for n, _ in olds] + ["this", "this"]
             + [f"old:{n}" for n, _ in reversed(olds)] + [f"wide{w}" for w in wides])
    for case in cases:
        b_ms, b_by = case.bound()
        times = [f"{name} {graph_ms(torch, libs[name].call(case)):.4f}" for name in order]
        say(f"[turn] {case.label}: graph ms (kernel + K1m) " + " / ".join(times)
            + f" | bound {b_ms:.4f} ({b_by})", fh)
    for target in [int(t) for t in args.targets.split(",") if t]:
        base = dec._CHUNK_TARGET_WARPGROUPS
        dec._CHUNK_TARGET_WARPGROUPS = target
        line = []
        for case in cases:
            plan = libs["this"].plan(case)
            line.append(f"{case.label} {graph_ms(torch, libs['this'].call(case, plan)):.4f} "
                        f"({plan[0]})")
        dec._CHUNK_TARGET_WARPGROUPS = base
        say(f"[target {target}] graph ms (splits): " + ", ".join(line), fh)
    verify_vs_decode(torch, libs, fh)
    ok &= bitwise(torch, libs, fh)
    say(f"[done] {'all checks hold' if ok else 'A CHECK FAILED'}", fh)
    shutil.rmtree(out_dir, ignore_errors=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
