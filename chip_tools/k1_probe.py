#!/usr/bin/env python3
"""K1's decode instance against its earlier versions, and the split count.

    python3 chip_tools/k1_probe.py --old NAME=DIR [--old NAME=DIR ...]

Each DIR holds a ``decode.cu`` (and the ``common.cuh`` it includes) from
an earlier tree; the sources' entry points are told apart by name and
arguments: ``fatt_decode_bhsd`` (the first, one-layout kernel),
``fatt_decode`` with a chunk argument (the template that also held chunk
mode) or without one (decode mode only, chunk mode on csrc/chunk_attn.cu).
Part 1 builds each of them and this tree's ``csrc/decode.cu`` with nvcc
and ``-Xptxas -v`` into its
own library, prints the registers, shared memory and spills of the fp8
decode instance and the size of its SASS (``cuobjdump -sass``: all
instructions, global and shared loads), then launches each through ctypes
on the same inputs (fp8 cache, B=8, H=32, Hk=8, S=4096, D=128, 5 splits,
the lengths of chip_smoke.py's K1 check), directly in a loop and as a
replayed CUDA graph, in turns (old..., this, this, ...old reversed).
Part 2 times ``flash_decode`` as the decode step calls it (K1 and the
K1m merge), K1's chunk mode and K8, as each wrapper picks its splits for
several targets of blocks (``ops/decode.py:_TARGET_BLOCKS``).

Every time is CUDA events over 200 launches (or 20 graph replays of 10;
chip_smoke.py's timers),
on one card; the card's name and power limit head the output.
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

import entry_args  # noqa: E402
from chip_smoke import cuda_ms, graph_ms  # noqa: E402

B, H, HK, S, D = 8, 32, 8, 4096, 128
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGS = {
    "fatt_decode_bhsd": [P] * 9 + [I] * 8 + [F, I, F, P],
    "fatt_decode+chunk": [P] * 9 + [I] * 10 + [F, F, I, F, P],
    "fatt_decode": [P] * 9 + [I] * 9 + [F, F, I, F, P],
}


def build(name, src_dir, out_dir, sass_dir=None):
    """(entry name, entry, ptxas lines of the fp8 decode instance, its SASS
    counts); with ``sass_dir`` also that instance's SASS as NAME.sass."""
    from flash_attn_tpu_torch import _build

    nvcc = _build.nvcc_path()
    lib = out_dir / f"lib{name}.so"
    cmd = [nvcc, *_build._ARCH, *_build._FLAGS, "-Xptxas", "-v", "-shared", "-I", str(src_dir),
           "-o", str(lib), str(src_dir / "decode.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"{name}: nvcc failed\n{res.stdout}{res.stderr}")
    # the fp8 (kv type 2) decode-mode BHSD instance: template <2>, <2, false,
    # false>, <2, false> or <2, false, 128>
    want = re.compile(r"decode_bhsd_kernelILi2EE|decode_kernelILi2ELb0E(Lb0E|Li128E)?E")
    lines, keep = [], False
    for line in res.stderr.splitlines():
        if "Compiling entry function" in line:
            keep = bool(want.search(line))
        if keep and ("Used" in line or "spill" in line):
            lines.append(line.strip())
    sass = {}
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    dump = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True).stdout
    cur, text = None, []
    for line in dump.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1) if want.search(m.group(1)) else None
            continue
        if cur and re.search(r"/\*[0-9a-f]{4}\*/", line):
            text.append(line)
            sass["instructions"] = sass.get("instructions", 0) + 1
            for op in ("LDG", "LDS", "LDGSTS", "STS", "FFMA", "BAR", "SHFL"):
                if re.search(rf"\b{op}\b|\b{op}\.", line):
                    sass[op] = sass.get(op, 0) + 1
    if sass_dir is not None:
        (sass_dir / f"{name}.sass").write_text("\n".join(text) + "\n")
    so = ctypes.CDLL(str(lib))
    entry = "fatt_decode" if hasattr(so, "fatt_decode") else "fatt_decode_bhsd"
    fn = getattr(so, entry)
    if entry == "fatt_decode":
        text = (src_dir / "decode.cu").read_text()
        head = text[text.index('extern "C" int fatt_decode('):]
        if "int chunk" in head[:head.index(")")]:
            entry = "fatt_decode+chunk"
    if entry == "fatt_decode_bhsd":
        fn.argtypes = SIGS[entry]
        fn.restype = ctypes.c_int
    else:
        fn = entry_args.bind(fn, src_dir / "decode.cu", "fatt_decode", SIGS[entry])
    return entry, fn, lines, sass


def inputs(torch):
    from flash_attn_tpu_torch.ops.quant import quantize_kv

    g = torch.Generator(device="cuda").manual_seed(1)
    q = torch.randn((B, H, D), generator=g, device="cuda", dtype=torch.bfloat16)
    kf = torch.randn((B, HK, S, D), generator=g, device="cuda", dtype=torch.bfloat16)
    vf = torch.randn((B, HK, S, D), generator=g, device="cuda", dtype=torch.bfloat16)
    lens = torch.randint(1, S + 1, (B,), generator=g, device="cuda", dtype=torch.int32)
    lens[0], lens[1] = S, 1
    kq, ks, vq, vs = quantize_kv(kf, vf, "fp8")
    return q, kq, vq, ks[..., 0].contiguous(), vs[..., 0].contiguous(), lens


def part1(torch, olds, sass_dir):
    from flash_attn_tpu_torch.ops import decode as dec

    q, k, v, ks, vs, lens = inputs(torch)
    nsplit, split_len = 5, 832
    part = torch.empty((nsplit, B, H, D), dtype=torch.float32, device="cuda")
    lse = torch.empty((nsplit, B, H), dtype=torch.float32, device="cuda")
    qscale = float(dec._qscale(D ** -0.5, True, torch.bfloat16))
    p = [t.data_ptr() for t in (q, k, v, ks, vs, lens)]
    out_dir = ROOT / "flash_attn_tpu_torch" / "_build" / "k1_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {}
    for name, src in [*olds, ("this", ROOT / "flash_attn_tpu_torch" / "csrc")]:
        entry, fn, lines, sass = build(name, Path(src), out_dir, sass_dir)
        print(f"[build] {name} ({entry}): {' | '.join(lines)} | SASS {sass}", flush=True)
        if entry == "fatt_decode_bhsd":
            args = (*p, None, part.data_ptr(), lse.data_ptr(), B, H, HK, S, D, 2, nsplit,
                    split_len, qscale, 1, 40.0)
        else:
            chunk = (1,) if entry == "fatt_decode+chunk" else ()
            args = (*p, None, part.data_ptr(), lse.data_ptr(), B, HK, H // HK, *chunk, S, D, 0,
                    2, nsplit, split_len, qscale, 1.0, 1, 40.0)
        libs[name] = (fn, args)
    ref = None
    for name, (fn, args) in libs.items():
        part.zero_()
        assert fn(*args, torch.cuda.current_stream().cuda_stream) == 0
        torch.cuda.synchronize()
        got = part.clone()
        ref = got if ref is None else ref
        print(f"[same result] {name}: max |partial - first| {float((got - ref).abs().max()):.3e}")
    order = [n for n, _ in olds] + ["this", "this"] + [n for n, _ in reversed(olds)]
    for name in order:
        fn, args = libs[name]
        def call(fn=fn, args=args):
            return fn(*args, torch.cuda.current_stream().cuda_stream)

        print(f"[turn] {name}: direct {cuda_ms(torch, call, iters=200, warmup=10):.4f} ms, graph "
              f"{graph_ms(torch, call):.4f} ms", flush=True)
    shutil.rmtree(out_dir, ignore_errors=True)


def part2(torch, targets):
    from flash_attn_tpu_torch.ops import decode as dec
    from flash_attn_tpu_torch.ops import paged_decode as pd

    q, k, v, ks, vs, lens = inputs(torch)
    g = torch.Generator(device="cuda").manual_seed(2)
    q64 = torch.randn((B, 64, D), generator=g, device="cuda", dtype=torch.bfloat16)
    qc = torch.randn((B, 5, H, D), generator=g, device="cuda", dtype=torch.bfloat16)
    lens_c = torch.clamp(lens, min=5)
    page = 128
    table = (1 + torch.arange(B * S // page, device="cuda", dtype=torch.int32)).reshape(B, -1)
    kpages = k.reshape(B, HK, S // page, page, D).transpose(1, 2).reshape(-1, HK, page, D)
    vpages = v.reshape(B, HK, S // page, page, D).transpose(1, 2).reshape(-1, HK, page, D)
    kpages = torch.cat([kpages[:1], kpages]).contiguous()
    vpages = torch.cat([vpages[:1], vpages]).contiguous()
    kps = ks.reshape(B, HK, S // page, page).transpose(1, 2).reshape(-1, HK, page)
    vps = vs.reshape(B, HK, S // page, page).transpose(1, 2).reshape(-1, HK, page)
    kps, vps = torch.cat([kps[:1], kps]).contiguous(), torch.cat([vps[:1], vps]).contiguous()
    calls = {
        "flash_decode G=4 (8B)": lambda: dec.flash_decode(
            q, k, v, k_scale=ks, v_scale=vs, kv_length=lens, kv_layout="bhsd"),
        "flash_decode G=8 (70B)": lambda: dec.flash_decode(
            q64, k, v, k_scale=ks, v_scale=vs, kv_length=lens, kv_layout="bhsd"),
        "flash_decode_chunk T=5 G=4": lambda: dec.flash_decode_chunk(
            qc, k, v, k_scale=ks, v_scale=vs, kv_length=lens_c),
        "paged_flash_decode page=128": lambda: pd.paged_flash_decode(
            q, kpages, vpages, table, lens, k_scale=kps, v_scale=vps),
    }
    base = dec._TARGET_BLOCKS
    for target in targets:
        dec._TARGET_BLOCKS = target
        times = {name: graph_ms(torch, fn) for name, fn in calls.items()}
        print(f"[splits] target {target}: " + ", ".join(
            f"{name} {ms:.4f} ms" for name, ms in times.items()), flush=True)
    dec._TARGET_BLOCKS = base


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", action="append", default=[], help="NAME=DIR of an earlier decode.cu")
    ap.add_argument("--targets", default="132,264,396,528,792,1056",
                    help="comma-separated; empty skips part 2")
    ap.add_argument("--sass-dir", type=Path, help="write each build's fp8 decode SASS here")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("k1_probe: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    if args.sass_dir:
        args.sass_dir.mkdir(parents=True, exist_ok=True)
    part1(torch, [tuple(o.split("=", 1)) for o in args.old], args.sass_dir)
    if args.targets:
        part2(torch, [int(t) for t in args.targets.split(",")])
    return 0


if __name__ == "__main__":
    sys.exit(main())
