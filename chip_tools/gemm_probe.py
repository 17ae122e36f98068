#!/usr/bin/env python3
"""K3, K3 grouped, K5, K6 and K7 against other versions of their source:
registers, errors, times, and a mutant that must fail.

    python3 chip_tools/gemm_probe.py [--old NAME=DIR ...] [--checks-only]
                                     [--decode-targets N,N,...]

Each DIR holds a ``matmul_q.cu`` (and the ``common.cuh`` it includes), for
example the parent tree's ``flash_attn_tpu_torch/csrc`` unpacked by ``git
archive``.  Two C interfaces are known: this tree's, whose last int is the
k-rows of a split (planned by ``ops/matmul.py:_q_plan``), and the earlier
one, whose last int is a split count (K split only at M <= 16: the
rule of that tree's ``_q_splits``, repeated here).  Each version, this
tree's ``csrc/matmul_q.cu`` and a mutant of it (the first group of each
split is never folded into the total) compile (``-Xptxas -v``, the flags
of ``_build.py``) into their own libraries under
``flash_attn_tpu_torch/_build/gemm_probe/`` and launch through ctypes:

  * registers, stack and spills of every kernel instance (ptxas);
  * each kind against its plain version (``ops/matmul.py``) on the card at
    chip_smoke.py's phase-2 shapes and at M = 8, 17, 32, 64, 100, 128 and
    256 (also 512 for K3 and K3 grouped, 1024 for K7), plus K6 and K5 at
    4096 x 6148 (N not a multiple of 128): the worst share of the row
    tolerance (2^-6 of the row's largest |ref|; K7 bit-exact, tolerance 0);
    the mutant must exceed the tolerance tenfold on K6 and K5 where K is at
    most 4096 (one lost group of 32 or fewer; its share is printed at every
    shape, and one group of 224 at K = 28672 lies near the tolerance);
  * CUDA-graph times in turns (old..., this, this, ...old reversed) at
    M = 8, 32, 64, 128, 256 (512 for K3 and K3 grouped, 1024 for K7) on
    every phase-2 shape, beside the bound of chip_smoke.py;
  * with ``--decode-targets``, this tree's M = 8 times at other values of
    ``_Q_DECODE_BLOCKS`` (the split target at decode).

Every line goes to ``chiprun_out/gemm_probe.txt`` and to stdout; the card's
name and power limit head it.  Exits nonzero if a check or the mutant's
failure does not hold.
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

P, I = ctypes.c_void_p, ctypes.c_int
FLOAT_SIG = [P] * 5 + [I] * 8 + [P]
S8_SIG = [P] * 6 + [I] * 7 + [P]
# the mutant: a split's first group is never folded into the total
FOLD = "        if constexpr (!C::kWhole) {\n"
EDITS = {"mutant": ((FOLD, "        if (!C::kWhole && (t > 0 || s >= kSpg)) {\n"),)}
# (kind, K, N): chip_smoke.py's phase-2 shapes, then the N tails
SHAPES = [("K3", 4096, 4096), ("K3", 4096, 1024), ("K3", 4096, 14336), ("K3", 14336, 4096),
          ("K3g", 4096, 14336),
          ("K6", 8192, 10240), ("K6", 8192, 8192), ("K6", 8192, 57344), ("K6", 28672, 8192),
          ("K5", 4096, 6144), ("K5", 4096, 4096), ("K5", 4096, 28672), ("K5", 14336, 4096),
          ("K7", 8192, 128256), ("K6", 4096, 6148), ("K5", 4096, 6148)]
TAILS = {("K6", 4096, 6148), ("K5", 4096, 6148)}
CHECK_M = (8, 17, 32, 64, 100, 128, 256)
TIME_M = (8, 32, 64, 128, 256)
EXTRA_M = {"K3": (512,), "K3g": (512,), "K7": (1024,)}
OUT = ROOT / "chiprun_out" / "gemm_probe.txt"


def say(msg, fh):
    print(msg, flush=True)
    fh.write(msg + "\n")
    fh.flush()


def interface(src: Path) -> str:
    text = src.read_text()
    head = text[text.index('extern "C" int fatt_matmul_float_q('):]
    return "kps" if "k_per_split" in head[:head.index(")")] else "splits"


def edited(src_dir: Path, out_dir: Path, name: str) -> Path:
    dst = out_dir / f"{name}_src"
    dst.mkdir(parents=True, exist_ok=True)
    shutil.copy(src_dir / "common.cuh", dst)
    text = (src_dir / "matmul_q.cu").read_text()
    for anchor, new in EDITS[name]:
        if text.count(anchor) != 1:
            raise RuntimeError(f"{name}: anchor not found once: {anchor!r}")
        text = text.replace(anchor, new)
    (dst / "matmul_q.cu").write_text(text)
    return dst


def start_build(name, src_dir, out_dir):
    """Start nvcc on src_dir's matmul_q.cu; finish_build waits for it."""
    from flash_attn_tpu_torch import _build

    lib = out_dir / f"lib{name}.so"
    cmd = [_build.nvcc_path(), *_build._ARCH, *_build._FLAGS, "-Xptxas", "-v", "-shared",
           "-I", str(src_dir), "-o", str(lib), str(src_dir / "matmul_q.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return name, src_dir, lib, proc


def finish_build(job, fh):
    """(interface, library) of a started build; its ptxas report to fh."""
    import ptxas_report

    name, src_dir, lib, proc = job
    out, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"{name}: nvcc failed\n{out}{err}")
    rows = ptxas_report.parse(err)
    for r, full in zip(rows, ptxas_report.demangle([r["name"] for r in rows])):
        say(f"[ptxas] {name}: regs {r['regs']:3d} stack {r.get('stack', 0):4d} spill st/ld "
            f"{r.get('spill_st', 0)}/{r.get('spill_ld', 0)}  {full}", fh)
    for line in err.splitlines():
        if re.search(r"wgmma|arning", line):
            say(f"[ptxas] {name}: {line.strip()}", fh)
    so = ctypes.CDLL(str(lib))
    so.fatt_matmul_float_q.argtypes = FLOAT_SIG
    so.fatt_matmul_s8_q.argtypes = S8_SIG
    so.fatt_matmul_float_q.restype = so.fatt_matmul_s8_q.restype = ctypes.c_int
    return interface(src_dir / "matmul_q.cu"), so


def old_splits(M, K, N):
    """The earlier tree's split count: K split only at decode."""
    if M > 16:
        return 1
    return max(1, min(-(-264 // -(-N // 128)), K // 256))


class Case:
    """One kind at one (K, N): weights, and per M the inputs and refs."""

    def __init__(self, torch, gen, kind, K, N):
        from chip_smoke import _int4_weight, _int8_grouped_weight
        from flash_attn_tpu_torch.ops.quant import quantize_int8

        self.torch, self.gen, self.kind, self.K, self.N = torch, gen, kind, K, N
        if kind in ("K6", "K5"):
            w = _int4_weight(torch, gen, K, N)
            self.w, self.s, self.g = w.packed, w.scales, 128
        elif kind == "K3g":
            self.w, self.s, _ = _int8_grouped_weight(torch, gen, K, N, 128)
            self.g = 128
        else:
            wf = torch.randn((K, N), generator=gen, device="cuda", dtype=torch.bfloat16) * 0.02
            w, s = quantize_int8(wf, dims=(0,))
            self.w, self.s, self.g = w.contiguous(), s[0].contiguous(), 0
            del wf
        self.inputs = {}

    def at(self, M):
        """(x, sx, out, ref): x bf16 (K3, K3g, K6) or per-token int8."""
        from flash_attn_tpu_torch.ops import matmul as mm

        torch = self.torch
        if M not in self.inputs:
            x = torch.randn((M, self.K), generator=self.gen, device="cuda", dtype=torch.bfloat16)
            sx = None
            out_dtype = torch.float32 if self.kind == "K7" else torch.bfloat16
            if self.kind in ("K5", "K7"):
                x, sx = mm.quantize_activations(x)
                sx = sx.contiguous()
            plain = {"K3": lambda: mm.matmul_int8_plain(x, self.w, self.s, out_dtype),
                     "K3g": lambda: mm.matmul_int8_grouped_plain(x, self.w, self.s, 128, out_dtype),
                     "K6": lambda: mm.matmul_int4_plain(x, self.w, self.s, 128, out_dtype),
                     "K5": lambda: mm.matmul_w4a8_plain(x, sx, self.w, self.s, 128, out_dtype),
                     "K7": lambda: mm.matmul_w8a8_plain(x, sx, self.w, self.s, out_dtype)}
            ref = plain[self.kind]()
            out = torch.empty((M, self.N), dtype=out_dtype, device="cuda")
            self.inputs[M] = (x, sx, out, ref)
        return self.inputs[M]

    def launcher(self, abi, so, M, plan=None):
        """A call of this version's kernel on the inputs at M (plan: this
        interface's (splits, k_per_split), default _q_plan's)."""
        torch = self.torch
        from flash_attn_tpu_torch.ops import matmul as mm

        x, sx, out, _ = self.at(M)
        if abi == "kps":
            splits, arg = plan or mm._q_plan(M, self.K, self.N)
        else:
            splits = arg = old_splits(M, self.K, self.N)
        part = None
        if splits > 1:
            dt = torch.int32 if self.kind == "K7" else torch.float32
            part = torch.empty((splits, M, self.N), dtype=dt, device="cuda")
        p = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        st = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
        bf16_out = int(out.dtype == torch.bfloat16)
        if self.kind in ("K5", "K7"):
            int4 = int(self.kind == "K5")

            def call():
                return so.fatt_matmul_s8_q(p(x), p(sx), p(self.w), p(self.s), p(out), p(part),
                                           M, self.K, self.N, self.g, int4, bf16_out, arg, st())
        else:
            int4 = int(self.kind == "K6")

            def call():
                return so.fatt_matmul_float_q(p(x), p(self.w), p(self.s), p(out), p(part), M,
                                              self.K, self.N, self.g, int4, 0, bf16_out, arg, st())
        call.part = part  # keep the scratch alive with the call
        return call

    def share(self, M):
        """Worst share of the row tolerance of the last launch's output (K7:
        the largest |error|, whose tolerance is 0)."""
        from chip_smoke import row_err

        _, _, out, ref = self.at(M)
        if self.kind == "K7":
            return float((out - ref).abs().max())
        return row_err(out, ref)[1]

    def bound(self, M):
        from chip_smoke import INT8_OPS_PER_S, bound

        K, N = self.K, self.N
        wbytes = K * N // 2 if self.kind in ("K6", "K5") else K * N
        sbytes = self.s.numel() * 4
        if self.kind in ("K5", "K7"):
            nbytes = M * K + M * 4 + wbytes + sbytes + M * N * (4 if self.kind == "K7" else 2)
            return bound(nbytes, 2 * M * K * N, INT8_OPS_PER_S)
        return bound(M * K * 2 + wbytes + sbytes + M * N * 2, 2 * M * K * N)


def timed(torch, call):
    """CUDA-graph ms of one call, graphs of about 2 ms."""
    from chip_smoke import cuda_ms, graph_ms

    est = cuda_ms(torch, call, iters=3, warmup=1)
    return graph_ms(torch, call, per_graph=max(1, min(10, int(2.0 / max(est, 1e-3)))), replays=10)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", action="append", default=[], help="NAME=DIR of another matmul_q.cu")
    ap.add_argument("--checks-only", action="store_true", help="no times")
    ap.add_argument("--decode-targets", default="", help="other _Q_DECODE_BLOCKS to time at M=8")
    ap.add_argument("--kinds", default="K3,K3g,K5,K6,K7", help="kinds to check and time")
    ap.add_argument("--sass", action="store_true",
                    help="this tree's SASS to chiprun_out/gemm_sass.txt")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("gemm_probe: no CUDA device", file=sys.stderr)
        return 1
    from flash_attn_tpu_torch.ops import matmul as mm

    OUT.parent.mkdir(parents=True, exist_ok=True)
    fh = OUT.open("w")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    say(f"card: {smi} | torch {torch.__version__}", fh)
    out_dir = ROOT / "flash_attn_tpu_torch" / "_build" / "gemm_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    olds = [tuple(o.split("=", 1)) for o in args.old]
    this = ROOT / "flash_attn_tpu_torch" / "csrc"
    jobs = [start_build(name, Path(src), out_dir)
            for name, src in [*olds, ("this", this), *((n, edited(this, out_dir, n)) for n in EDITS)]]
    libs = {job[0]: finish_build(job, fh) for job in jobs}
    if args.sass:
        from flash_attn_tpu_torch import _build

        cuobjdump = Path(_build.nvcc_path()).parent / "cuobjdump"
        sass = subprocess.run([str(cuobjdump), "-sass", str(out_dir / "libthis.so")],
                              capture_output=True, text=True).stdout
        (OUT.parent / "gemm_sass.txt").write_text(sass)
    gen = torch.Generator(device="cuda").manual_seed(11)
    ok = True

    kinds = args.kinds.split(",")
    for kind, K, N in SHAPES:
        if kind not in kinds:
            continue
        case = Case(torch, gen, kind, K, N)
        ms_check = (8, 17, 100, 256) if (kind, K, N) in TAILS else CHECK_M + EXTRA_M.get(kind, ())
        for M in ms_check:
            line = []
            for name in [n for n, _ in olds] + ["this", *EDITS]:
                if name == "mutant" and kind not in ("K6", "K5"):
                    continue
                abi, so = libs[name]
                call = case.launcher(abi, so, M)
                rc = call()
                torch.cuda.synchronize()
                share = case.share(M) if rc == 0 else float("nan")
                if name == "mutant":
                    good = rc == 0 and (share >= 10.0 or K > 4096)
                else:
                    good = rc == 0 and share <= (0.0 if kind == "K7" else 1.0)
                ok &= good or name not in ("this", "mutant")
                line.append(f"{name} {share:.3f}{'' if good else ' FAIL'}")
            say(f"[check] {kind} M={M} K={K} N={N}: " + ", ".join(line)
                + (" (K7: max |err|, tol 0)" if kind == "K7" else " (share of the row tolerance;"
                   " the mutant must reach 10 at K <= 4096)"), fh)
        if args.checks_only or (kind, K, N) in TAILS:
            continue
        order = [n for n, _ in olds] + ["this", "this"] + [n for n, _ in reversed(olds)]
        for M in TIME_M + EXTRA_M.get(kind, ()):
            b_ms, b_by = case.bound(M)
            times = [f"{name} {timed(torch, case.launcher(*libs[name], M)):.4f}" for name in order]
            say(f"[turn] {kind} M={M} K={K} N={N}: graph ms " + " / ".join(times)
                + f" | bound {b_ms:.4f} ({b_by}) | plan {mm._q_plan(M, K, N)}", fh)
        if args.decode_targets:
            line = []
            for target in [int(t) for t in args.decode_targets.split(",")]:
                base = mm._Q_DECODE_BLOCKS
                mm._Q_DECODE_BLOCKS = target
                plan = mm._q_plan(8, K, N)
                mm._Q_DECODE_BLOCKS = base
                line.append(f"{target}: {timed(torch, case.launcher(*libs['this'], 8, plan)):.4f} "
                            f"(splits {plan[0]})")
            say(f"[decode target] {kind} M=8 K={K} N={N}: " + ", ".join(line), fh)
        del case
        torch.cuda.empty_cache()
    say(f"[done] {'all checks hold' if ok else 'A CHECK FAILED'}", fh)
    shutil.rmtree(out_dir, ignore_errors=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
