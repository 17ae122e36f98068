#!/usr/bin/env python3
"""K4 against other versions of its source: registers, errors and times.

    python3 chip_tools/k4_probe.py [--old NAME=DIR ...]

Each DIR holds a ``flash_fwd.cu`` (and the ``common.cuh`` it includes),
for example an earlier tree's ``flash_attn_tpu_torch/csrc`` or a copy of
this one with a design change to try; every version exports
``fatt_flash_fwd`` with one signature.  Each, and this tree's
``csrc/flash_fwd.cu``, compiles (``-Xptxas -v``, the flags of
``_build.py``) into its own library under
``flash_attn_tpu_torch/_build/k4_probe/`` and launches through ctypes at
the training and prefill shape (B=1, S=2048, H=32, Hk=8, D=128, causal,
rope) in both softmax modes: the largest output error as a share of its
row's tolerance (2^-6 of the row's largest |ref|, as chip_smoke.py holds
K4), the LSE error, whether output and LSE are bitwise those of the first
version, and the time (CUDA events over 20 launches, after warm-up), in
turns (old..., this, this, ...old reversed).  The card's name
and power limit head the output.
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

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIG = [P] * 7 + [I] * 7 + [F, I, I, P]


def build(name, src_dir, out_dir):
    from flash_attn_tpu_torch import _build

    lib = out_dir / f"lib{name}.so"
    cmd = [_build.nvcc_path(), *_build._ARCH, *_build._FLAGS, "-Xptxas", "-v", "-shared",
           "-I", str(src_dir), "-o", str(lib), str(src_dir / "flash_fwd.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"{name}: nvcc failed\n{res.stdout}{res.stderr}")
    info = " | ".join(x.replace("ptxas info    :", "").strip() for x in res.stderr.splitlines()
                      if re.search(r"Used \d+ registers|spill|wgmma|arning", x))
    fn = ctypes.CDLL(str(lib)).fatt_flash_fwd
    fn.argtypes = SIG
    fn.restype = ctypes.c_int
    return fn, info


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", action="append", default=[], help="NAME=DIR of another flash_fwd.cu")
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
    olds = [tuple(o.split("=", 1)) for o in args.old]
    fns = {}
    for name, src in [*olds, ("this", ROOT / "flash_attn_tpu_torch" / "csrc")]:
        fns[name], info = build(name, Path(src), out_dir)
        print(f"[build] {name}: {info}", flush=True)
    order = [n for n, _ in olds] + ["this", "this"] + [n for n, _ in reversed(olds)]
    first = {}  # softmax mode -> the first version's (out, lse)
    for name in order:
        fn = fns[name]
        line = []
        for clamped in (True, False):
            def call(fn=fn, clamped=clamped):
                return fn(*ptrs, B, S, S, H, Hk, D, 0, eff, 1, int(clamped),
                          torch.cuda.current_stream().cuda_stream)
            assert call() == 0
            torch.cuda.synchronize()
            rout, rlse = refs[clamped]
            _, share = row_err(out, rout)
            lerr = float((lse - rlse).abs().max())
            f_out, f_lse = first.setdefault(clamped, (out.clone(), lse.clone()))
            same = torch.equal(out, f_out) and torch.equal(lse, f_lse)
            ms = cuda_ms(torch, call)
            line.append(f"{'clamped' if clamped else 'online'} {ms:.4f} ms "
                        f"({flops / ms / 1e9:.1f} TFLOP/s), share {share:.3f}, lse err {lerr:.2e}, "
                        f"bitwise {order[0]}'s {same}")
        print(f"[turn] {name}: " + "; ".join(line), flush=True)
    shutil.rmtree(out_dir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
