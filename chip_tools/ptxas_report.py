#!/usr/bin/env python3
"""Registers, shared memory and spills of the port's CUDA kernels, as
``nvcc -Xptxas -v`` reports them for sm_90a.

    python3 chip_tools/ptxas_report.py [SOURCE.cu ...]

With no arguments it reports every ``flash_attn_tpu_torch/csrc/*.cu``.
Each source compiles in its own nvcc process, all started together, with
the flags of ``flash_attn_tpu_torch/_build.py``; nothing is linked or
kept.  One line per kernel instance: its demangled name, registers,
static shared memory, stack frame and spill bytes.  Needs nvcc (the
machine with the card); exits nonzero if a source does not compile.
"""

from __future__ import annotations

import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

_FUNC = re.compile(r"Compiling entry function '(\S+)'")
_PROPS = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")


def demangle(names):
    filt = shutil.which("cu++filt") or shutil.which("c++filt")
    if not filt or not names:
        return names
    out = subprocess.run([filt], input="\n".join(names), capture_output=True, text=True)
    got = out.stdout.splitlines()
    return got if len(got) == len(names) else names


def parse(text):
    """[(mangled name, registers, smem bytes, stack, spill stores, spill loads)]"""
    rows, cur = [], None
    for line in text.splitlines():
        m = _FUNC.search(line)
        if m:
            cur = {"name": m.group(1)}
            continue
        if cur is None:
            continue
        m = _PROPS.search(line)
        if m:
            cur.update(stack=int(m.group(1)), spill_st=int(m.group(2)), spill_ld=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["regs"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(sm.group(1)) if sm else 0
            rows.append(cur)
            cur = None
    return rows


def main(argv) -> int:
    from flash_attn_tpu_torch import _build

    nvcc = _build.nvcc_path()
    csrc = ROOT / "flash_attn_tpu_torch" / "csrc"
    sources = [Path(a) for a in argv] or sorted(csrc.glob("*.cu"))
    procs = []
    for src in sources:
        cmd = [nvcc, *_build._ARCH, *_build._FLAGS, "-Xptxas", "-v", "-I", str(src.parent),
               "-I", str(ROOT / "flash_attn_tpu_torch" / "csrc"), "-c", str(src), "-o", "/dev/null"]
        procs.append((src, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True)))
    rc = 0
    for src, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"{src}: nvcc failed\n{out}")
            rc = 1
            continue
        rows = parse(out)
        names = demangle([r["name"] for r in rows])
        print(f"== {src.relative_to(ROOT) if src.is_relative_to(ROOT) else src}")
        for r, name in zip(rows, names):
            print(f"  regs {r['regs']:3d} smem {r['smem']:6d} stack {r.get('stack', 0):4d} "
                  f"spill st/ld {r.get('spill_st', 0)}/{r.get('spill_ld', 0)}  {name}")
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
