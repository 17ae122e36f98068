#!/usr/bin/env python3
"""K11 against other versions of its source: registers, errors, times, and
a one-pass TF32 mutant that must miss.

    python3 chip_tools/k11_probe.py [--old NAME=DIR ...] [--variants no_s,no_pv]

Each DIR holds a ``ring_attn.cu`` (and the ``common.cuh`` it includes),
for example the parent tree's ``flash_attn_tpu_torch/csrc`` unpacked by
``git archive``; every version exports ``fatt_ring_attn`` with one C
interface.  Each version, this tree's ``csrc/ring_attn.cu`` and the
mutant ``one_pass`` (this tree's with only the hi x hi product of each
three-pass TF32 product: one TF32 pass) compile together (``-Xptxas -v``,
the flags of ``_build.py``) into their own libraries under
``flash_attn_tpu_torch/_build/k11_probe/``; each kernel instance's
registers, stack and spills are printed.  Each launches through ctypes
(the slots sized for the larger layout: this tree's TF32 hi and lo planes) at
chip_smoke.py's K11 cases: Llama-3-8B's attention widths over 4 ranks of
S_loc 4096 (B=1, H=32, Hk=8, D=128), fp32 and bf16 in, causal and not, and
``K11_SMALL`` (a ragged S_loc, G=1 at head_dim 64, 8 ranks, 1 rank, and
large logits: q x 8, causal, fp32).  Each is held to ``ring_attn_plain``
by chip_smoke.py's row rule (2^-12 of the row's largest |ref| for fp32
out, 2^-6 for bf16), a second launch bitwise the first; each line also
says whether the outputs are bitwise the first version's.  The mutant must
miss the large-logit case by 10x or more (its share of the row tolerance
is printed on every case); the probe exits 1 otherwise, or when a version
that is not the mutant misses a case.  Then the fp32 8B cases, causal and
not, are timed (CUDA events over 3 calls after one) in turns (old...,
this, this, ...old reversed), then the mutant once (its time says how
much of the call the two small passes take), with SDPA's
memory-efficient backend on the gathered fp32 sequence (KV heads
repeated) beside them.  The card's name
and power limit head the output; every line is also written to
``chiprun_out/k11_probe.txt``.  ``--variants`` adds design diagnostics,
anchor edits of this tree's source (VARIANTS) timed once at the 8B causal
call after the turns and held to nothing: ``no_s`` (no S product) and
``no_pv`` (no PV product), what each product costs the call.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import ptxas_report  # noqa: E402

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIG = [P] * 5 + [I] * 8 + [F, P, P]
# this tree's source with one TF32 pass: qk3 (S) and pv3 (PV) keep only
# hi x hi
QK3 = ("      fatt::wgmma_tf32(sd, al[buf][i], fatt::wg_desc(fatt::kmajor<kKeys>(kh, ks)));\n"
       "      fatt::wgmma_tf32(sd, ah[buf][i], fatt::wg_desc(fatt::kmajor<kKeys>(kl, ks)));\n")
PV3 = ("    fatt::wgmma_tf32(od, al[j], fatt::wg_desc(fatt::kmajor<D>(vh, j)));\n"
       "    fatt::wgmma_tf32(od, ah[j], fatt::wg_desc(fatt::kmajor<D>(vl, j)));\n")
EDITS = {"one_pass": ((QK3, "", 1), (PV3, "", 1))}
# design diagnostics (timed only): (anchor, replacement, times it matches)
VARIANTS = {"no_s": (("      if (!skip) qk3<D, G::kQPitch>(",
                      "      if (tile < 0) qk3<D, G::kQPitch>(", 1),),
            "no_pv": (("        pv3<D>(o, ah, al, vh, vh + G::kPlane);",
                       "        if (tile < 0) pv3<D>(o, ah, al, vh, vh + G::kPlane);", 1),)}
MUST_MISS = "large logits, q x8"
MISS_FACTOR = 10.0
LINES = []


def say(msg: str) -> None:
    LINES.append(msg)
    print(msg, flush=True)


def edited(src_dir: Path, out_dir: Path, name: str) -> Path:
    """A copy of src_dir's sources with EDITS[name] (or VARIANTS[name])
    applied."""
    dst = out_dir / f"{name}_src"
    dst.mkdir(parents=True, exist_ok=True)
    shutil.copy(src_dir / "common.cuh", dst)
    text = (src_dir / "ring_attn.cu").read_text()
    for anchor, new, times in {**EDITS, **VARIANTS}[name]:
        if text.count(anchor) != times:
            raise RuntimeError(f"{name}: anchor not found {times} times: {anchor!r}")
        text = text.replace(anchor, new)
    (dst / "ring_attn.cu").write_text(text)
    return dst


def compile_lib(name, src_dir, out_dir):
    from flash_attn_tpu_torch import _build

    lib = out_dir / f"lib{name}.so"
    cmd = [_build.nvcc_path(), *_build._ARCH, *_build._FLAGS, "-Xptxas", "-v", "-shared",
           "-I", str(src_dir), "-o", str(lib), str(src_dir / "ring_attn.cu")]
    return lib, subprocess.run(cmd, capture_output=True, text=True)


def load(name, lib, res):
    if res.returncode != 0:
        raise RuntimeError(f"{name}: nvcc failed\n{res.stdout}{res.stderr}")
    rows = ptxas_report.parse(res.stderr)
    names = ptxas_report.demangle([r["name"] for r in rows])
    info = " | ".join(f"{n[n.find('ring_attn_kernel'):n.find('>(') + 1]}: {r['regs']} "
                      f"registers, stack {r.get('stack', 0)}, spill st/ld "
                      f"{r.get('spill_st', 0)}/{r.get('spill_ld', 0)}"
                      for r, n in zip(rows, names))
    fn = ctypes.CDLL(str(lib)).fatt_ring_attn
    fn.argtypes = SIG
    fn.restype = ctypes.c_int
    return fn, info


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", action="append", default=[], help="NAME=DIR of another ring_attn.cu")
    ap.add_argument("--variants", default="", help="comma-separated VARIANTS to time")
    args = ap.parse_args()
    variants = [v for v in args.variants.split(",") if v]
    import torch

    if not torch.cuda.is_available():
        print("k11_probe: no CUDA device", file=sys.stderr)
        return 1
    import torch.nn.functional as F_
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from chip_smoke import (K11_B, K11_D, K11_H, K11_HK, K11_N, K11_SLOC, K11_SMALL, _k11_inputs,
                            cuda_ms, k11_pairs, row_err)
    from flash_attn_tpu_torch.parallel.rdma_ring import KEY_TILE, ring_attn_plain

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    say(f"card: {smi}")
    out_dir = ROOT / "flash_attn_tpu_torch" / "_build" / "k11_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    olds = [tuple(o.split("=", 1)) for o in args.old]
    this = ROOT / "flash_attn_tpu_torch" / "csrc"
    srcs = [*olds, ("this", this), *((n, edited(this, out_dir, n)) for n in EDITS)]
    diags = [(n, edited(this, out_dir, n)) for n in variants]
    fns = {}
    with concurrent.futures.ThreadPoolExecutor(len(srcs) + len(diags)) as pool:
        jobs = [(name, pool.submit(compile_lib, name, Path(src), out_dir))
                for name, src in srcs + diags]
        for name, job in jobs:
            fns[name], info = load(name, *job.result())
            say(f"[build] {name}: {info}")
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def runner(name, qs, ks, vs, causal):
        """A call of version ``name`` on these shards, and its outputs."""
        n = len(qs)
        B, s_loc, H, D = qs[0].shape
        Hk = ks[0].shape[2]
        outs = [torch.empty_like(q) for q in qs]
        ptrs = torch.tensor([t.data_ptr() for t in (*qs, *ks, *vs, *outs)], dtype=torch.int64,
                            device="cuda")
        s_pad = -(-s_loc // KEY_TILE) * KEY_TILE
        slots = torch.empty((n, 2, 4, B, Hk, s_pad, D), dtype=torch.float32, device="cuda")
        acc = torch.empty((n, B, H, s_loc, D), dtype=torch.float32, device="cuda")
        lse = torch.empty((n, B, H, s_loc), dtype=torch.float32, device="cuda")
        counters = torch.empty((2 * n * n,), dtype=torch.int32, device="cuda")
        info = (ctypes.c_int * 2)()
        bf16 = int(qs[0].dtype == torch.bfloat16)

        def call():
            return fns[name](ptrs.data_ptr(), slots.data_ptr(), acc.data_ptr(), lse.data_ptr(),
                             counters.data_ptr(), n, B, s_loc, H, Hk, D, bf16, int(causal),
                             float(D ** -0.5), info, stream())
        return call, outs, info

    g = torch.Generator(device="cuda").manual_seed(11)
    big = [(f"8B {dt} {'causal' if c else 'non-causal'}", K11_N, K11_B, K11_H, K11_HK, K11_D,
            K11_SLOC, c, dt, 1.0) for dt in ("float32", "bfloat16") for c in (True, False)]
    small = [(label, n, B, H, Hk, D, S, causal, dt, qm)
             for label, n, B, H, Hk, D, S, _, causal, dt, qm in K11_SMALL]
    ok = True
    inputs = {}
    for label, n, B, H, Hk, D, S, causal, dt, qm in big + small:
        key = (n, B, H, Hk, D, S, dt, qm)
        if key not in inputs:
            inputs.clear()
            torch.cuda.empty_cache()
            inputs[key] = _k11_inputs(torch, g, n, B, S, H, Hk, D, dt, qm)
        qs, ks, vs = inputs[key]
        ref = torch.stack(ring_attn_plain(qs, ks, vs, causal, D ** -0.5))
        rel = 2.0 ** -6 if dt == "bfloat16" else 2.0 ** -12
        first = None
        for name, _ in srcs:
            call, outs, info = runner(name, qs, ks, vs, causal)
            assert call() == 0, name
            got = torch.stack(outs).clone()
            assert call() == 0, name
            torch.cuda.synchronize()
            repeat = torch.equal(got, torch.stack(outs))
            err, share = row_err(got, ref, rel=rel)
            first = got if first is None else first
            same = torch.equal(got, first)
            held = share <= 1.0 and repeat
            if name in EDITS:
                must = label == MUST_MISS
                missed = share >= MISS_FACTOR
                if must:
                    ok = ok and missed
                note = (f"misses by {share:.1f}x (must miss by {MISS_FACTOR:g}x: "
                        f"{'ok' if missed else 'FAIL'})" if must else "reported")
            else:
                ok = ok and held
                note = "held" if held else "MISSED"
            say(f"[check] {label} (n={n}, B={B}, H={H}, Hk={Hk}, D={D}, S_loc={S}, q x{qm:g}), "
                f"{name}: max_abs_err {err:.3e}, share of the row tolerance (rel {rel:g}) "
                f"{share:.4f}, repeat bitwise {repeat}, bitwise {srcs[0][0]}'s {same}, grid "
                f"{(info[0], info[1])}; {note}")
            del got
        del ref
    inputs.clear()
    torch.cuda.empty_cache()

    qs, ks, vs = _k11_inputs(torch, g, K11_N, K11_B, K11_SLOC, K11_H, K11_HK, K11_D, "float32")
    turns = [n for n, _ in olds] + ["this", "this"] + [n for n, _ in reversed(olds)]
    for causal in (True, False):
        flops = 4 * K11_D * K11_B * K11_H * k11_pairs(K11_N, K11_SLOC, causal)
        what = "causal" if causal else "non-causal"
        for name in turns + list(EDITS) + (variants if causal else []):
            call, _, _ = runner(name, qs, ks, vs, causal)
            ms = cuda_ms(torch, call, iters=3, warmup=1)
            kind = "turn" if name not in EDITS and name not in variants else (
                "mutant" if name in EDITS else "variant")
            say(f"[{kind}] 8B fp32 {what}, {name}: {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s "
                f"of fp32 products)")
        qg = torch.cat(qs, dim=1).transpose(1, 2).contiguous()
        kg, vg = (torch.cat(x, dim=1).repeat_interleave(K11_H // K11_HK, dim=2).transpose(1, 2)
                  .contiguous() for x in (ks, vs))
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            lib_ms = cuda_ms(torch, lambda: F_.scaled_dot_product_attention(
                qg, kg, vg, is_causal=causal), iters=3, warmup=1)
        del qg, kg, vg
        say(f"[library] 8B fp32 {what}: SDPA's memory-efficient backend, fp32, the gathered "
            f"sequence: {lib_ms:.4f} ms; bound (three TF32 passes at 495 TFLOP/s) "
            f"{3 * flops / 495e12 * 1e3:.4f} ms")
    shutil.rmtree(out_dir, ignore_errors=True)
    say(f"[probe] {'ok' if ok else 'FAIL'}")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "k11_probe.txt").write_text("\n".join(LINES) + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
