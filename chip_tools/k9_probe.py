#!/usr/bin/env python3
"""K9 and K10 against other versions of their source: registers, errors,
times, and a mutant that must fail.

    python3 chip_tools/k9_probe.py [--old NAME=DIR ...]

Each DIR holds a ``flash_bwd.cu`` (and the ``common.cuh`` it includes),
for example the parent tree's ``flash_attn_tpu_torch/csrc`` unpacked by
``git archive``.  Two C interfaces are known: this tree's (K9 also writes
R(q), which K10 reads) and the earlier one in which both passes rotate q
themselves.  Each version,
this tree's ``csrc/flash_bwd.cu``, a build of it with one warpgroup a
block ("wg1": 64 query rows in K9, 64 keys in K10) and a mutant of it
(K9 skips its second K/V tile, K10 its second query tile) compile
(``-Xptxas -v``, the flags of ``_build.py``) into their own libraries under
``flash_attn_tpu_torch/_build/k9_probe/`` and launch through ctypes at the
training shape (B=1, S=2048, H=32, Hk=8, D=128, causal, rope).  Each is
held to ``flash_bwd_plain`` as chip_smoke.py holds K9 and K10: dq, and dk
and dv summed over each GQA group, every row within 2^-6 of its largest
|ref| (plus the floors); the worst share of that tolerance is printed, and
the mutant must exceed it.  Times: CUDA events over 20 launches and
CUDA-graph replays, in turns (old..., this, wg1, wg1, this, ...old
reversed), and K10 followed by the reduction ``flash_bwd`` makes of its
outputs (the sum over each GQA group, then dk and dv in bf16 as
[B, Sk, Hk, D]).  Each check line also says whether dq, dk and dv are
bitwise those of the first version.
The card's name and power limit head the output.
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
# (dq entry, dkv entry) argument types of each interface
SIGS = {"rq": ([P] * 10 + [I] * 7 + [F, I, P], [P] * 8 + [I] * 6 + [F, I, P]),
        "rotate": ([P] * 9 + [I] * 7 + [F, I, P], [P] * 10 + [I] * 7 + [F, I, P])}
# edits of this tree's source, each (anchor, replacement) matching once:
# the mutant adds a `continue` after the tile's offset in each loop; "wg1"
# gives each block one warpgroup (64 query rows in K9, 64 keys in K10)
K9 = "    const int k0 = t * kRows;\n"
K10 = "    float st[32], dpt[32];\n"
EDITS = {"mutant": ((K9, K9 + "if (t == 1) { __syncthreads(); continue; }\n"),
                    (K10, "if (it == 1) { __syncthreads(); continue; }\n" + K10)),
         "wg1": (("constexpr int kWarpgroups = 2;", "constexpr int kWarpgroups = 1;"),)}


def interface(src: Path) -> str:
    text = src.read_text()
    head = text[text.index('extern "C" int fatt_flash_bwd_dq('):]
    return "rq" if "void* rq" in head[:head.index(")")] else "rotate"


def edited(src_dir: Path, out_dir: Path, name: str) -> Path:
    """A copy of src_dir's sources with EDITS[name] applied."""
    dst = out_dir / f"{name}_src"
    dst.mkdir(parents=True, exist_ok=True)
    shutil.copy(src_dir / "common.cuh", dst)
    text = (src_dir / "flash_bwd.cu").read_text()
    for anchor, new in EDITS[name]:
        if text.count(anchor) != 1:
            raise RuntimeError(f"{name}: anchor not found once: {anchor!r}")
        text = text.replace(anchor, new)
    (dst / "flash_bwd.cu").write_text(text)
    return dst


def build(name, src_dir, out_dir):
    from flash_attn_tpu_torch import _build

    lib = out_dir / f"lib{name}.so"
    cmd = [_build.nvcc_path(), *_build._ARCH, *_build._FLAGS, "-Xptxas", "-v", "-shared",
           "-I", str(src_dir), "-o", str(lib), str(src_dir / "flash_bwd.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"{name}: nvcc failed\n{res.stdout}{res.stderr}")
    info = " | ".join(x.replace("ptxas info    :", "").strip() for x in res.stderr.splitlines()
                      if re.search(r"Compiling entry|Used \d+ registers|spill|wgmma|arning", x))
    so = ctypes.CDLL(str(lib))
    abi = interface(src_dir / "flash_bwd.cu")
    fns = []
    for fn, sig in zip((so.fatt_flash_bwd_dq, so.fatt_flash_bwd_dkv), SIGS[abi]):
        fn.argtypes = sig
        fn.restype = ctypes.c_int
        fns.append(fn)
    return abi, fns, info


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", action="append", default=[], help="NAME=DIR of another flash_bwd.cu")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("k9_probe: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import _bwd_inputs, cuda_ms, graph_ms, k4_flops, one_key_floor, row_err
    from flash_attn_tpu_torch.ops import flash_bwd as fb
    from flash_attn_tpu_torch.ops.rope import rope_rotate

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    out_dir = ROOT / "flash_attn_tpu_torch" / "_build" / "k9_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    B, S, H, Hk, D = 1, 2048, 32, 8, 128
    G = H // Hk
    g = torch.Generator(device="cuda").manual_seed(5)
    q, k, v, dout, lse, delta, cos, sin = _bwd_inputs(torch, g, B, S, S, True, True, H, Hk, D)
    scale = D ** -0.5
    rdq, rdk, rdv = fb.flash_bwd_plain(q, k, v, dout, lse, delta, True, scale, cos, sin)
    rdk, rdv = (x.reshape(B, Hk, G, S, D).sum(2) for x in (rdk, rdv))
    floor = one_key_floor(torch, rdq, S, True)
    rq_ref = rope_rotate(q, cos, sin)
    gemm = k4_flops(B, S, S, H, D) // 2
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    olds = [tuple(o.split("=", 1)) for o in args.old]
    this = ROOT / "flash_attn_tpu_torch" / "csrc"
    srcs = [*olds, ("this", this), *((n, edited(this, out_dir, n)) for n in EDITS)]
    libs = {}
    for name, src in srcs:
        libs[name] = build(name, Path(src), out_dir)
        print(f"[build] {name} ({libs[name][0]}): {libs[name][2]}", flush=True)

    def runner(name):
        """(K9 call, K10 call, K10 then the GQA reduction flash_bwd makes of
        its outputs, outputs -> (dq, dk, dv) group-summed)."""
        abi, (f9, f10), _ = libs[name]
        sk_pad = -(-S // 64) * 64
        dq = torch.empty((B, S, H, D), dtype=torch.float32, device="cuda")
        rq = torch.empty_like(q)
        dk = torch.empty((B, H, sk_pad, D), dtype=torch.float32, device="cuda")
        dv = torch.empty_like(dk)
        ptr = lambda t: t.data_ptr()  # noqa: E731
        common = [ptr(t) for t in (q, k, v, dout, lse, delta, cos, sin)]
        if abi == "rq":
            c9 = lambda: f9(*common, ptr(dq), ptr(rq), B, S, S, H, Hk, D, 0, scale, 1,  # noqa
                            stream())
            c10 = lambda: f10(ptr(rq), *common[1:6], ptr(dk), ptr(dv), B, S, S, H, Hk, D,  # noqa
                              scale, 1, stream())
        else:
            c9 = lambda: f9(*common, ptr(dq), B, S, S, H, Hk, D, 0, scale, 1, stream())  # noqa
            c10 = lambda: f10(*common, ptr(dk), ptr(dv), B, S, S, H, Hk, D, 0, scale, 1,  # noqa
                              stream())

        def group_sum():
            return [x[:, :, :S].reshape(B, Hk, G, S, D).sum(2) for x in (dk, dv)]

        def c10_reduced():  # [B, Sk, Hk, D] bf16, as flash_bwd returns dk and dv
            c10()
            return [x.transpose(1, 2).to(torch.bfloat16) for x in group_sum()]

        def outs():
            return (dq, *group_sum(), torch.equal(rq, rq_ref) if abi == "rq" else None)
        return c9, c10, c10_reduced, outs

    labels = [n for n, _ in olds] + ["this", *EDITS]
    first = None
    for label in labels:
        c9, c10, _, outs = runner(label)
        assert c9() == 0 and c10() == 0, label
        torch.cuda.synchronize()
        dq, dk, dv, rq_ok = outs()
        first = first or (dq.clone(), dk.clone(), dv.clone())
        same = all(torch.equal(a, b) for a, b in zip((dq, dk, dv), first))
        shares = [row_err(dq, rdq, floor=floor)[1], row_err(dk, rdk)[1], row_err(dv, rdv)[1]]
        print(f"[check] {label}: share of the row tolerance dq {shares[0]:.3f}, dk "
              f"{shares[1]:.3f}, dv {shares[2]:.3f}"
              f"{'' if rq_ok is None else f'; R(q) bitwise {rq_ok}'}; bitwise {labels[0]}'s "
              f"{same}", flush=True)

    order = [n for n, _ in olds] + ["this", "wg1", "wg1", "this"] + [n for n, _ in reversed(olds)]
    for label in order:
        c9, c10, c10r, _ = runner(label)
        ms9, ms10 = cuda_ms(torch, c9), cuda_ms(torch, c10)
        g9, g10, g10r = graph_ms(torch, c9), graph_ms(torch, c10), graph_ms(torch, c10r)
        print(f"[turn] {label}: K9 {ms9:.4f} ms (graph {g9:.4f}, {3 * gemm / g9 / 1e9:.1f} "
              f"TFLOP/s); K10 {ms10:.4f} ms (graph {g10:.4f}, {4 * gemm / g10 / 1e9:.1f} "
              f"TFLOP/s); K9 + K10 graph {g9 + g10:.4f} ms; K10 and the GQA reduction "
              f"(graph) {g10r:.4f} ms", flush=True)
    shutil.rmtree(out_dir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
