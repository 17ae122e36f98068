#!/usr/bin/env python3
"""Drive the PyTorch port (flash_attn_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, one line each with its seconds:
  1. environment: card name and power limit, CUDA, nvcc, kernel build time;
  2. each hand-written kernel (K1 decode, K2 kv-append, K3 int8 matmul,
     K4 flash forward) against its plain PyTorch version on the card at the
     Llama-3-8B shapes, with its time (CUDA events), its bound and the time
     of one PyTorch library call for the same function;
  3. a 2-layer model at full 8B widths with int8 weights and fp8 KV: two
     prompts and four decode steps on the card (kernels) against the CPU
     (plain versions);
  4. the main path: Llama-3-8B (32 layers, random int8 weights from a seed)
     served by the continuous-batching engine, 8 greedy requests, fp8 KV
     then int8 KV, with the launch count of every kernel in each run.

The last two lines are the kernels' JSON record and the card, then the
last line is {"ok": true, "device": {...}}.  Any failed check exits
nonzero without that line; so does a machine without CUDA or a directory
without the rest of the repository.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
BF16_FLOPS_PER_S = 989e12      # H100 SXM dense bf16 tensor cores
SEED = 0


def say(msg: str) -> None:
    print(msg, flush=True)


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def row_err(got, ref):
    """(max |got - ref|, worst share of its row's tolerance).

    A row is one output vector (a query's head, a product's row).  Its
    tolerance is two bf16 ulps of its largest |ref| (2^-6 of it): the
    kernel and its plain version differ by the bf16 rounding of the output
    and of fp32 values summed in another order, at most one ulp of an
    element, and no element's ulp exceeds 2^-7 of the row's largest.  A
    long attention row has small outputs, so a tolerance taken from the
    whole tensor's largest value (a short row's) would not see a lost or
    doubled tile there."""
    g = got.float().reshape(-1, got.shape[-1])
    r = ref.float().reshape(-1, ref.shape[-1])
    err = (g - r).abs()
    tol = 2.0 ** -6 * r.abs().amax(dim=-1, keepdim=True) + 1e-6
    return float(err.max()), float((err / tol).max())


def k1_bytes(k, kv_length, k_scale) -> int:
    """Bytes K1 must move for these inputs: every live K/V row and scale
    once (q and out are counted by the caller)."""
    import torch

    B, Hk, S, D = k.shape
    live = int(torch.clamp(kv_length.long(), max=S).sum())
    per_row = D * k.element_size() + (4 if k_scale is not None else 0)
    return 2 * Hk * live * per_row


def k4_flops(B, Sq, Sk, H, D) -> int:
    """Operations causal K4 must do: 4*D per (query, key) pair it attends
    to under the bottom-right mask."""
    shift = Sk - Sq
    pairs = sum(max(0, min(Sk, i + shift + 1)) for i in range(Sq))
    return 4 * B * H * D * pairs


def cuda_ms(torch, fn, iters=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


class Checks:
    def __init__(self):
        self.failed = []

    def check(self, name: str, err: float, tol: float) -> bool:
        ok = err <= tol
        if not ok:
            self.failed.append(f"{name}: err {err:.3e} > tol {tol:.3e}")
        return ok


def phase_env(torch):
    from flash_attn_tpu_torch import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    _build.lib()
    say(f"[phase 1 env] card: {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | nvcc {_build.nvcc_path()} | kernel build "
        f"{_build.build_seconds:.2f}s | {time.perf_counter() - t0:.2f}s")
    return smi


def check_k3(torch, checks, rows):
    from flash_attn_tpu_torch.ops import matmul as mm
    from flash_attn_tpu_torch.ops.quant import quantize_int8

    g = torch.Generator(device="cuda").manual_seed(SEED)
    worst = 0.0
    main = None
    for (K, N) in ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096)):
        wf = torch.randn((K, N), generator=g, device="cuda", dtype=torch.bfloat16) * 0.02
        wq, s = quantize_int8(wf, dims=(0,))
        wq, s = wq.contiguous(), s[0].contiguous()
        del wf
        for M in (8, 512):
            x = torch.randn((M, K), generator=g, device="cuda", dtype=torch.bfloat16)
            got = mm.matmul_int8_cuda(x, wq, s, torch.bfloat16)
            ref = mm.matmul_int8_plain(x, wq, s, torch.bfloat16)
            torch.cuda.synchronize()
            err, share = row_err(got, ref)
            ok = checks.check(f"K3 M={M} K={K} N={N}", share, 1.0)
            worst = max(worst, err)
            ms = cuda_ms(torch, lambda: mm.matmul_int8_cuda(x, wq, s, torch.bfloat16))
            plain_ms = cuda_ms(torch, lambda: mm.matmul_int8_plain(x, wq, s, torch.bfloat16), iters=5)
            lib_ms = cuda_ms(torch, lambda: torch.matmul(x, wq.bfloat16()) * s)
            b_ms, b_by = bound(M * K * 2 + K * N + N * 4 + M * N * 2, 2 * M * K * N)
            say(f"  K3 M={M} K={K} N={N}: max_abs_err {err:.3e} ({share:.3f} of its "
                f"row's tol) {'ok' if ok else 'FAIL'} | {ms:.4f} ms, plain {plain_ms:.4f}, "
                f"library {lib_ms:.4f}, bound {b_ms:.4f} ({b_by})")
            if (M, K, N) == (8, 4096, 14336):
                main = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                            bound_ms=b_ms, bound_by=b_by)
    rows["K3"] = dict(name="int8_matmul (M=8, K=4096, N=14336)",
                      source="flash_attn_tpu_torch/csrc/matmul_int8.cu",
                      replaces="flash_attn_tpu/ops/matmul.py:60",
                      max_abs_err=worst, **main)


def _decode_inputs(torch, kv, g, B=8, H=32, Hk=8, S=4096, D=128):
    from flash_attn_tpu_torch.ops.quant import quantize_kv

    q = torch.randn((B, H, D), generator=g, device="cuda", dtype=torch.bfloat16)
    kf = torch.randn((B, Hk, S, D), generator=g, device="cuda", dtype=torch.bfloat16)
    vf = torch.randn((B, Hk, S, D), generator=g, device="cuda", dtype=torch.bfloat16)
    lens = torch.randint(1, S + 1, (B,), generator=g, device="cuda", dtype=torch.int32)
    lens[0], lens[1] = S, 1
    if kv == "bf16":
        return q, kf, vf, None, None, lens
    kq, ks, vq, vs = quantize_kv(kf, vf, kv)
    return q, kq, vq, ks[..., 0].contiguous(), vs[..., 0].contiguous(), lens


def check_k1(torch, checks, rows):
    import torch.nn.functional as F

    from flash_attn_tpu_torch.ops import decode as dec

    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    worst = 0.0
    for kv in ("bf16", "int8", "fp8"):
        q, k, v, ks, vs, lens = _decode_inputs(torch, kv, g)
        B, H, D = q.shape
        S = k.shape[2]
        mode = dec._default_softmax_mode(k.dtype)
        clamped = mode == "clamped"
        clamp2 = dec.CLAMP2_DEC_FP8 if kv == "fp8" else dec.CLAMP2_DEC
        nsplit, split_len = dec._splits(B, k.shape[1], S, None)
        args = (q, k, v, ks, vs, lens, D ** -0.5, clamped, clamp2, nsplit, split_len)
        got, glse = dec.flash_decode(q, k, v, k_scale=ks, v_scale=vs, kv_length=lens,
                                     return_lse=True)
        po, pl = dec.flash_decode_plain(*args)
        ref, rlse = dec.lse_merge(po, pl, dim=0)
        torch.cuda.synchronize()
        err, share = row_err(got, ref.to(torch.bfloat16))
        # fp32 sums of at most 4096 terms in another order: far below 1e-3,
        # while a lost or doubled 64-key tile moves a row's LSE by > 1e-2
        lerr = float((glse - rlse).abs().max())
        ok = checks.check(f"K1 {kv} out", share, 1.0) & checks.check(f"K1 {kv} lse", lerr, 1e-3)
        worst = max(worst, err)
        ms = cuda_ms(torch, lambda: dec.flash_decode_cuda(*args))
        call_ms = cuda_ms(torch, lambda: dec.flash_decode(q, k, v, k_scale=ks, v_scale=vs, kv_length=lens))
        plain_ms = cuda_ms(torch, lambda: dec.flash_decode_plain(*args), iters=3)
        kd = k.float() if ks is None else k.float() * ks[..., None]
        vd = v.float() if vs is None else v.float() * vs[..., None]
        kd, vd = kd.bfloat16(), vd.bfloat16()
        mask = (torch.arange(S, device="cuda")[None, :] < lens[:, None].long())[:, None, None, :]
        lib_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            q[:, :, None, :], kd, vd, attn_mask=mask, enable_gqa=True))
        live = int(lens.long().clamp(max=S).sum())
        nbytes = k1_bytes(k, lens, ks) + 2 * q.numel() * 2 + lens.numel() * 4
        b_ms, b_by = bound(nbytes, 4 * H * D * live)
        say(f"  K1 {kv} ({mode}, {nsplit} splits): max_abs_err {err:.3e} ({share:.3f} of "
            f"its row's tol), lse err {lerr:.3e} (tol 1e-3) "
            f"{'ok' if ok else 'FAIL'} | {ms:.4f} ms ({call_ms:.4f} with the LSE merge), "
            f"plain {plain_ms:.4f}, library (SDPA on the dequantized cache) {lib_ms:.4f}, bound {b_ms:.4f} ({b_by})")
        if kv == "fp8":
            rows["K1"] = dict(name="decode_bhsd (B=8, H=32, Hk=8, S=4096, fp8 KV)",
                              source="flash_attn_tpu_torch/csrc/decode.cu",
                              replaces="flash_attn_tpu/ops/decode.py:747",
                              ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                              bound_ms=b_ms, bound_by=b_by)
        del q, k, v, ks, vs, kd, vd
    rows["K1"]["max_abs_err"] = worst


def check_k2(torch, checks, rows):
    from flash_attn_tpu_torch.ops import kv_append as ka

    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    B, Hk, S, D = 8, 8, 4096, 128
    worst = 0.0
    for mode, dt in (("int8", torch.int8), ("fp8", torch.float8_e4m3fn)):
        if mode == "int8":
            kc = torch.randint(-127, 128, (B, Hk, S, D), generator=g, device="cuda",
                               dtype=torch.int8)
        else:
            kc = torch.randn((B, Hk, S, D), generator=g, device="cuda").to(dt)
        vc = kc.clone()
        ks = torch.rand((B, Hk, S), generator=g, device="cuda")
        vs = ks.clone()
        nk = torch.randn((B, Hk, D), generator=g, device="cuda", dtype=torch.bfloat16) * 3
        nv = torch.randn((B, Hk, D), generator=g, device="cuda", dtype=torch.bfloat16)
        lens = torch.randint(0, S, (B,), generator=g, device="cuda", dtype=torch.int32)
        lens[0] = S + 5  # an idle slot past the capacity writes nothing
        bufs = [t.clone() for t in (kc, vc, ks, vs)]
        ka.kv_append_cuda(kc, vc, ks, vs, nk, nv, lens, mode)
        ka.kv_append_plain(*bufs, nk, nv, lens, mode)
        torch.cuda.synchronize()
        err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip((kc, vc, ks, vs), bufs))
        # the same IEEE division and round-to-nearest-even: bit-exact
        ok = checks.check(f"K2 {mode}", err, 0.0)
        worst = max(worst, err)
        ms = cuda_ms(torch, lambda: ka.kv_append_cuda(kc, vc, ks, vs, nk, nv, lens, mode), iters=100)
        plain_ms = cuda_ms(torch, lambda: ka.kv_append_plain(kc, vc, ks, vs, nk, nv, lens, mode))
        nbytes = 2 * B * Hk * D * 2 + 2 * B * Hk * D * 1 + 2 * B * Hk * 4 + B * 4
        b_ms, b_by = bound(nbytes, 0)
        say(f"  K2 {mode}: max_abs_err {err:.3e} (tol 0) {'ok' if ok else 'FAIL'} | "
            f"{ms:.4f} ms, plain {plain_ms:.4f}, library none, bound {b_ms:.6f} ({b_by})")
        if mode == "fp8":
            rows["K2"] = dict(name="kv_append (B=8, Hk=8, S=4096, D=128, fp8)",
                              source="flash_attn_tpu_torch/csrc/kv_append.cu",
                              replaces="flash_attn_tpu/ops/kv_append.py:57",
                              ms=ms, plain_ms=plain_ms, library_ms=None,
                              bound_ms=b_ms, bound_by=b_by)
    rows["K2"]["max_abs_err"] = worst


def check_k4(torch, checks, rows):
    import torch.nn.functional as F

    from flash_attn_tpu_torch.ops import flash_fwd as ff
    from flash_attn_tpu_torch.ops.rope import rope_cos_sin, rope_rotate

    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    B, S, H, Hk, D = 1, 2048, 32, 8, 128
    q = torch.randn((B, S, H, D), generator=g, device="cuda", dtype=torch.bfloat16)
    k = torch.randn((B, S, Hk, D), generator=g, device="cuda", dtype=torch.bfloat16)
    v = torch.randn((B, S, Hk, D), generator=g, device="cuda", dtype=torch.bfloat16)
    cos, sin = rope_cos_sin(torch.arange(S, device="cuda")[None], D, 500000.0)
    worst = 0.0
    for mode in ("clamped", "online"):
        clamped = mode == "clamped"
        out, lse = ff.flash_fwd(q, k, v, causal=True, rope_cos=cos, rope_sin=sin,
                                softmax_mode=mode)
        rout, rlse = ff.flash_fwd_plain(q, k, v, True, D ** -0.5, cos, sin, clamped)
        torch.cuda.synchronize()
        err, share = row_err(out, rout)
        lerr = float((lse - rlse).abs().max())
        ok = checks.check(f"K4 {mode} out", share, 1.0) & checks.check(f"K4 {mode} lse", lerr, 1e-3)
        worst = max(worst, err)
        ms = cuda_ms(torch, lambda: ff.flash_fwd_cuda(q, k, v, True, D ** -0.5, cos, sin, clamped))
        plain_ms = cuda_ms(torch, lambda: ff.flash_fwd_plain(q, k, v, True, D ** -0.5, cos, sin, clamped), iters=3)
        qr = rope_rotate(q, cos, sin).transpose(1, 2).contiguous()
        kt, vt = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
        lib_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qr, kt, vt, is_causal=True, enable_gqa=True))
        flops = k4_flops(B, S, S, H, D)
        nbytes = (q.numel() * 2 * 2 + k.numel() * 2 * 2 + cos.numel() * 4 * 2
                  + lse.numel() * 4)
        b_ms, b_by = bound(nbytes, flops)
        say(f"  K4 {mode}: max_abs_err {err:.3e} ({share:.3f} of its row's tol), lse err {lerr:.3e} "
            f"(tol 1e-3) {'ok' if ok else 'FAIL'} | {ms:.4f} ms "
            f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f}, library (SDPA "
            f"on rotated q) {lib_ms:.4f}, bound {b_ms:.4f} ({b_by})")
        if clamped:
            rows["K4"] = dict(name="flash_fwd (B=1, S=2048, H=32, Hk=8, D=128, causal, rope, clamped)",
                              source="flash_attn_tpu_torch/csrc/flash_fwd.cu",
                              replaces="flash_attn_tpu/ops/flash_fwd.py:221",
                              ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                              bound_ms=b_ms, bound_by=b_by)
    rows["K4"]["max_abs_err"] = worst


def phase_kernels(torch, checks):
    t0 = time.perf_counter()
    rows = {}
    check_k3(torch, checks, rows)
    check_k1(torch, checks, rows)
    check_k2(torch, checks, rows)
    check_k4(torch, checks, rows)
    torch.cuda.empty_cache()
    say(f"[phase 2 kernels vs plain] {'ok' if not checks.failed else 'FAIL'} | "
        f"{time.perf_counter() - t0:.2f}s")
    return rows


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    if isinstance(tree, tuple):
        return tuple(_to(v, device) for v in tree)
    return tree.to(device)


def phase_card_vs_cpu(torch, checks):
    """2 layers at full 8B widths, int8 weights, fp8 KV: two prompts and
    four decode steps in lockstep on the card and on the CPU, fed the same
    tokens (the CPU's greedy choices)."""
    import numpy as np

    from flash_attn_tpu_torch.models import llama

    t0 = time.perf_counter()
    cfg = dataclasses.replace(llama.LLAMA3_8B, num_layers=2)
    cpu_params = llama.init_params(cfg, seed=SEED + 4, device="cpu", quantize="int8")
    sides = {"cpu": cpu_params, "cuda": _to(cpu_params, "cuda")}
    caches = {d: llama.make_cache(cfg, 2, 256, mode="fp8", device=d) for d in sides}
    rng = np.random.default_rng(SEED + 4)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (100, 37)]
    logits = {d: [] for d in sides}
    for slot, prompt in enumerate(prompts):
        toks = torch.zeros((1, 128), dtype=torch.long)
        toks[0, :len(prompt)] = torch.tensor(prompt)
        for d, params in sides.items():
            out, kvs = llama.prefill_with_kv(params, toks.to(d), torch.arange(128, device=d)[None], cfg)
            for layer, (k, v) in enumerate(kvs):
                caches[d].insert_prompt(layer, slot, k[0], v[0])
            caches[d].set_length(slot, len(prompt))
            logits[d].append(out[0, len(prompt) - 1].float().cpu())
    nxt = torch.stack([logits["cpu"][0].argmax(), logits["cpu"][1].argmax()])
    for _ in range(4):
        for d, params in sides.items():
            out, _ = llama.decode_step(params, nxt.to(d), cfg, caches[d])
            logits[d].extend(out.float().cpu())
        nxt = torch.stack(logits["cpu"][-2:]).argmax(-1)
    torch.cuda.synchronize()
    ref = torch.stack(logits["cpu"])
    got = torch.stack(logits["cuda"])
    finite = bool(torch.isfinite(got).all())
    err = float((got - ref).abs().max())
    # bf16 activations: kernels and plain versions round at the same points,
    # so only summation order differs; it can flip a bf16 (2^-8) or an fp8
    # KV (2^-4) rounding, which two layers carry into the logits
    tol = 5e-2 * float(ref.abs().max())
    ok = checks.check("card vs cpu logits", err, tol) and finite
    if not finite:
        checks.failed.append("card logits not finite")
    agree = int((got.argmax(-1) == ref.argmax(-1)).sum())
    say(f"[phase 3 card vs cpu, 2 layers at 8B widths, int8 weights, fp8 KV] logits "
        f"{tuple(got.shape)} finite={finite} max_abs_err {err:.3e} (tol {tol:.3e}, "
        f"max |logit| {float(ref.abs().max()):.3f}) {'ok' if ok else 'FAIL'} | greedy "
        f"agreement {agree}/{ref.shape[0]} | {time.perf_counter() - t0:.2f}s")
    del sides, caches, cpu_params
    torch.cuda.empty_cache()


def _counters():
    from flash_attn_tpu_torch.ops.decode import flash_decode_cuda
    from flash_attn_tpu_torch.ops.flash_fwd import flash_fwd_cuda
    from flash_attn_tpu_torch.ops.kv_append import kv_append_cuda
    from flash_attn_tpu_torch.ops.matmul import matmul_int8_cuda

    return {"K1": flash_decode_cuda, "K2": kv_append_cuda,
            "K3": matmul_int8_cuda, "K4": flash_fwd_cuda}


def phase_serve(torch, checks):
    """The main path: Llama-3-8B (32 layers) through the engine, fp8 KV
    then int8 KV.  Returns the launch counts of the fp8 run."""
    import numpy as np

    from flash_attn_tpu_torch.engine.engine import InferenceEngine
    from flash_attn_tpu_torch.models import llama

    t0 = time.perf_counter()
    cfg = llama.LLAMA3_8B
    torch.cuda.reset_peak_memory_stats()
    params = llama.init_params(cfg, seed=SEED, device="cuda", quantize="int8")
    torch.cuda.synchronize()
    say(f"  8B params (int8 weights, bf16 embeddings and head) on the card in "
        f"{time.perf_counter() - t0:.2f}s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    rng = np.random.default_rng(SEED)
    lens = rng.integers(128, 1025, 8)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist() for n in lens]
    first = None
    for kv_mode in ("fp8", "int8"):
        t1 = time.perf_counter()
        eng = InferenceEngine(params, llama.make_adapter(cfg), max_batch=8,
                              capacity=4096, kv_mode=kv_mode, device="cuda")
        counters = _counters()
        for fn in counters.values():
            fn.launches = 0
        reqs = [eng.submit(p, max_tokens=32) for p in prompts]
        eng.run()
        torch.cuda.synchronize()
        counts = {k: fn.launches for k, fn in counters.items()}
        snap = eng.metrics.snapshot()
        good = all(r.done and len(r.generated) == 32
                   and all(0 <= t < cfg.vocab_size for t in r.generated) for r in reqs)
        if not good:
            checks.failed.append(f"serve {kv_mode}: a request did not finish with 32 valid tokens")
        if min(counts.values()) <= 0:
            checks.failed.append(f"serve {kv_mode}: a kernel was not launched: {counts}")
        m = eng.metrics
        say(f"[phase 4 serve Llama-3-8B, {kv_mode} KV] 8 requests, prompts "
            f"{lens.tolist()}, 32 tokens each: {'ok' if good else 'FAIL'} | prefill "
            f"{m.prefill_tokens / max(m.prefill_seconds, 1e-9):.1f} tok/s | decode "
            f"{m.decode_tokens / max(m.decode_seconds, 1e-9):.1f} tok/s "
            f"({snap['decode_step_ms']} ms/step) | max_memory_allocated "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | "
            f"{time.perf_counter() - t1:.2f}s")
        say("kernels " + json.dumps({"kv": kv_mode, **counts}))
        if first is None:
            first = counts
        del eng
        torch.cuda.empty_cache()
    return first


def main() -> int:
    t_start = time.perf_counter()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "flash_attn_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    checks = Checks()
    smi = phase_env(torch)
    rows = phase_kernels(torch, checks)
    phase_card_vs_cpu(torch, checks)
    counts = phase_serve(torch, checks)
    for key, row in rows.items():
        row["launches"] = counts[key]
    say(f"[total] {time.perf_counter() - t_start:.2f}s")
    if checks.failed:
        for f in checks.failed:
            print("FAILED " + f, file=sys.stderr)
        return 1
    kernels = [dict(name=r["name"], route="cuda", source=r["source"],
                    replaces=r["replaces"], launches=r["launches"],
                    max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
                    bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                    library_ms=r["library_ms"])
               for r in (rows[k] for k in ("K1", "K2", "K3", "K4"))]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
