#!/usr/bin/env python3
"""Time this tree against another checkout on one card, in turns.

    python3 chip_tools/ab_turns.py --other DIR [--order OTTO]
                                   [--models all|serve|train|chunk|none]

DIR is another checkout of the repository (for example the parent commit
unpacked with ``git archive`` into a directory that .gitignore lists).
Each turn is a fresh process that imports ``flash_attn_tpu_torch`` from
one tree ("T" this tree, "O" the other) and runs the same measurements
(this file's code) through that tree's public wrappers, so the two trees
differ only in the package they bring.  The default order O, T, T, O
shows drift as well as the difference.

Kernel level (CUDA events; "loop": 20 calls from Python, the wrapper's
host work included; "graph": 10 calls captured in a CUDA graph, replayed
20 times, the device's time alone):
  K4 clamped and online, B=1 S=2048 H=32 Hk=8 D=128, causal, rope, and
  flash_bwd as the training step calls it at that shape (delta, K9, K10
  and the GQA group's sum);
  K1 fp8 alone and flash_decode as the decode step calls it (BHSD, B=8,
  H=32, Hk=8, S=4096, chip_smoke.py's lengths), and the merge alone on
  K1's partials (merge_splits: K1m where the tree has it);
  K1's chunk mode (T=5) alone and flash_decode_chunk as called;
  K1 over a BSHD cache alone and flash_decode with its default layout;
  K8 (pages of 128) alone and paged_flash_decode as called; K8's chunk
  mode (T=128 over 512 resident tokens) alone and as called.
Model level (``--models``, default all; random weights from seed 0, the
prompts of chip_smoke.py): Llama-3-8B int8 weights, fp8 KV, 8 requests x
32 tokens (ms per decode step, prefill tokens/s); the same with W4A8 g=128
layers + W8A8 head, fused; Llama-3-70B int4 g=128 + W8A8 head, fused, fp8
KV, 8 x 16 tokens (the serving runs: ``--models serve``, or all; left out
with ``--models train``); training Llama-3-8B (32 layers, bf16, B=1,
S=2048, remat, 5 AdamW steps: median ms of steps 2-5; all or train); the
chunk kernel's paths on Llama-3-8B int8, as chip_smoke.py phases 9a, 9b
and 7 run them (all or chunk): n-gram speculation with fp8 KV and a
self-draft with bf16 KV (4 drafts; ms per verify round, and the
self-draft's acceptance), and the paged engine with prefix caching, fp8
KV (the second wave's 8 prefix hits: seconds and tokens/s of their suffix
prefills).

Prints one "turn" JSON line per turn and a table: each metric's value in
every turn.  The card's name and power limit head the output.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SEED = 0
# this tree's timers; chip_smoke.py imports nothing of the package at load
sys.path.insert(0, str(ROOT))
from chip_smoke import _prompts, cuda_ms, graph_ms  # noqa: E402


def kernels(torch, res):
    import flash_attn_tpu_torch as fat
    from flash_attn_tpu_torch.ops import decode as dec
    from flash_attn_tpu_torch.ops import flash_bwd as fb
    from flash_attn_tpu_torch.ops import flash_fwd as ff
    from flash_attn_tpu_torch.ops import paged_decode as pd
    from flash_attn_tpu_torch.ops.quant import quantize_kv
    from flash_attn_tpu_torch.ops.rope import rope_cos_sin

    def both(name, fn):
        res[f"{name} loop"] = cuda_ms(torch, fn)
        res[f"{name} graph"] = graph_ms(torch, fn)

    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    B, S, H, Hk, D = 1, 2048, 32, 8, 128
    q = torch.randn((B, S, H, D), generator=g, device="cuda", dtype=torch.bfloat16)
    k = torch.randn((B, S, Hk, D), generator=g, device="cuda", dtype=torch.bfloat16)
    v = torch.randn((B, S, Hk, D), generator=g, device="cuda", dtype=torch.bfloat16)
    cos, sin = rope_cos_sin(torch.arange(S, device="cuda")[None], D, 500000.0)
    for clamped in (True, False):
        both(f"K4 {'clamped' if clamped else 'online'}",
             lambda: ff.flash_fwd_cuda(q, k, v, True, D ** -0.5, cos, sin, clamped))
    out, lse = ff.flash_fwd(q, k, v, causal=True, rope_cos=cos, rope_sin=sin)
    dout = torch.randn((B, S, H, D), generator=g, device="cuda", dtype=torch.bfloat16)
    both("flash_bwd as called", lambda: fb.flash_bwd(q, k, v, out, lse, dout, causal=True,
                                                     rope_cos=cos, rope_sin=sin))
    del q, k, v, out, dout

    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    B, S = 8, 4096
    q = torch.randn((B, H, D), generator=g, device="cuda", dtype=torch.bfloat16)
    kf = torch.randn((B, Hk, S, D), generator=g, device="cuda", dtype=torch.bfloat16)
    vf = torch.randn((B, Hk, S, D), generator=g, device="cuda", dtype=torch.bfloat16)
    lens = torch.randint(1, S + 1, (B,), generator=g, device="cuda", dtype=torch.int32)
    lens[0], lens[1] = S, 1
    k, ks4, v, vs4 = quantize_kv(kf, vf, "fp8")
    ks, vs = ks4[..., 0].contiguous(), vs4[..., 0].contiguous()
    del kf, vf
    clamped, clamp2 = True, dec.CLAMP2_DEC_FP8
    nsplit, split_len = dec._splits(B, Hk, S, None)
    res["K1 splits"] = nsplit
    args = (q, k, v, ks, vs, lens, D ** -0.5, clamped, clamp2, nsplit, split_len)
    both("K1 alone", lambda: dec.flash_decode_cuda(*args))
    both("flash_decode as called", lambda: dec.flash_decode(
        q, k, v, k_scale=ks, v_scale=vs, kv_length=lens, kv_layout="bhsd"))
    outs, lses = dec.flash_decode_cuda(*args)
    both("merge alone", lambda: dec.merge_splits(outs, lses, torch.bfloat16))

    T = 5
    qc = torch.randn((B, T, H, D), generator=g, device="cuda", dtype=torch.bfloat16)
    lens_c = torch.clamp(lens, min=T)
    q2 = qc.reshape(B, T, Hk, H // Hk, D).transpose(1, 2).reshape(B, -1, D).contiguous()
    if hasattr(dec, "_chunk_splits"):  # the chunk kernel: splits of the live walk
        nsplit_c, split_len_c = dec._chunk_splits(B, Hk, T * H // Hk, S, None), None
    else:
        nsplit_c, split_len_c = dec._splits(B * -(-(T * H // Hk) // dec.ROWS), Hk, S, None)
    args_c = (q2, k, v, ks, vs, lens_c, D ** -0.5, clamped, clamp2, nsplit_c, split_len_c, T)
    both("K1c alone", lambda: dec.flash_decode_cuda(*args_c))
    both("flash_decode_chunk as called", lambda: dec.flash_decode_chunk(
        qc, k, v, k_scale=ks, v_scale=vs, kv_length=lens_c))

    kb, vb = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    ksb, vsb = ks4.transpose(1, 2).contiguous(), vs4.transpose(1, 2).contiguous()  # [B, S, Hk, 1]
    args_b = (q, kb, vb, ksb[..., 0].contiguous(), vsb[..., 0].contiguous(), lens, D ** -0.5,
              False, clamp2, nsplit, split_len, 1, "bshd")
    both("K1b alone", lambda: dec.flash_decode_cuda(*args_b))
    both("flash_decode BSHD as called", lambda: fat.flash_decode(
        q, kb, vb, k_scale=ksb, v_scale=vsb, kv_length=lens))
    del kb, vb

    page = 128
    kp = k.reshape(B, Hk, S // page, page, D).transpose(1, 2).reshape(-1, Hk, page, D)
    vp = v.reshape(B, Hk, S // page, page, D).transpose(1, 2).reshape(-1, Hk, page, D)
    ksp = ks.reshape(B, Hk, S // page, page).transpose(1, 2).reshape(-1, Hk, page)
    vsp = vs.reshape(B, Hk, S // page, page).transpose(1, 2).reshape(-1, Hk, page)
    kp, vp = torch.cat([kp[:1], kp]).contiguous(), torch.cat([vp[:1], vp]).contiguous()
    ksp, vsp = torch.cat([ksp[:1], ksp]).contiguous(), torch.cat([vsp[:1], vsp]).contiguous()
    table = (1 + torch.arange(B * S // page, device="cuda", dtype=torch.int32)).reshape(B, -1)
    if hasattr(pd, "_plan"):  # K8 splits the live walk and merges in the kernel
        nsplit_p, split_len_p = pd._plan(B, Hk, H // Hk, 1, S, None)
    else:
        nsplit_p, split_len_p = dec._splits(B, Hk, S, None)
    args_p = (q, kp, vp, ksp, vsp, table, lens, D ** -0.5, clamped, clamp2, 1, nsplit_p,
              split_len_p)
    both("K8 alone", lambda: pd.paged_flash_decode_cuda(*args_p))
    both("paged_flash_decode as called", lambda: pd.paged_flash_decode(
        q, kp, vp, table, lens, k_scale=ksp, v_scale=vsp))

    # K8's chunk mode as chip_smoke.py holds it: one sequence, 512 tokens
    # resident and a 128-token chunk, the table's reach S
    T, kv_len = 128, 640
    qc = torch.randn((1, T, H, D), generator=g, device="cuda", dtype=torch.bfloat16)
    lens_1 = torch.tensor([kv_len], dtype=torch.int32, device="cuda")
    q2 = qc.reshape(1, T, Hk, H // Hk, D).transpose(1, 2).reshape(1, -1, D).contiguous()
    if hasattr(dec, "_chunk_splits"):
        nsplit_pc, split_len_pc = dec._chunk_splits(1, Hk, T * H // Hk, S, None), None
    else:
        target = [pd._CHUNK_TARGET_BLOCKS] if hasattr(pd, "_CHUNK_TARGET_BLOCKS") else []
        nsplit_pc, split_len_pc = dec._splits(pd._row_tiles(T * H // Hk), Hk, S, None, *target)
    res["K8c splits"] = nsplit_pc
    args_pc = (q2, kp, vp, ksp, vsp, table[:1], lens_1, D ** -0.5, clamped, clamp2, T,
               nsplit_pc, split_len_pc)
    both("K8c alone", lambda: pd.paged_flash_decode_cuda(*args_pc))
    both("paged_flash_decode_chunk as called", lambda: pd.paged_flash_decode_chunk(
        qc, kp, vp, table[:1], lens_1, k_scale=ksp, v_scale=vsp))


def serve(torch, res, label, cfg, max_tokens, **quant):
    from flash_attn_tpu_torch.engine.engine import InferenceEngine
    from flash_attn_tpu_torch.models import llama

    params = llama.init_params(cfg, seed=SEED, device="cuda", **quant)
    eng = InferenceEngine(params, llama.make_adapter(cfg), max_batch=8, capacity=4096,
                          kv_mode="fp8", device="cuda")
    for p in _prompts(cfg.vocab_size)[1]:
        eng.submit(p, max_tokens=max_tokens)
    eng.run()
    torch.cuda.synchronize()
    snap = eng.metrics.snapshot()
    res[f"{label} ms/step"] = snap["decode_step_ms"]
    res[f"{label} prefill tok/s"] = snap["prefill_tokens_per_s"]
    del eng, params
    torch.cuda.empty_cache()


def chunk_paths(torch, res):
    import numpy as np

    from flash_attn_tpu_torch.engine.engine import (InferenceEngine, PagedInferenceEngine,
                                                    SpecConfig)
    from flash_attn_tpu_torch.models import llama

    cfg = llama.LLAMA3_8B
    params = llama.init_params(cfg, seed=SEED, device="cuda", quantize="int8")
    adapter = llama.make_adapter(cfg)
    for label, kv_mode, spec in (
            ("n-gram", "fp8", SpecConfig(num_draft=4, ngram=2)),
            ("self-draft", "none", SpecConfig(num_draft=4, draft_params=params,
                                              draft_adapter=adapter))):
        eng = InferenceEngine(params, adapter, max_batch=8, capacity=4096, kv_mode=kv_mode,
                              spec=spec, device="cuda")
        for p in _prompts(cfg.vocab_size)[1]:
            eng.submit(p, max_tokens=32)
        eng.run()
        torch.cuda.synchronize()
        m = eng.metrics
        res[f"8B {label} spec ms/round"] = 1e3 * m.decode_seconds / max(m.steps, 1)
        if label == "self-draft":
            res["8B self-draft acceptance"] = m.snapshot()["spec_draft_acceptance"]
        del eng
    rng = np.random.default_rng(SEED + 7)  # chip_smoke.py's phase-7 traffic
    prefix = rng.integers(0, cfg.vocab_size, 512).tolist()
    suffix_lens = rng.integers(64, 513, 16)
    prompts = [prefix + rng.integers(0, cfg.vocab_size, int(n)).tolist() for n in suffix_lens]
    eng = PagedInferenceEngine(params, adapter, max_batch=8, capacity=4096, page_size=128,
                               kv_mode="fp8", prefix_cache=True, device="cuda")
    m = eng.metrics
    for wave in (prompts[:8], prompts[8:]):
        tokens, secs = m.prefill_tokens, m.prefill_seconds
        for p in wave:
            eng.submit(p, max_tokens=32)
        eng.run()
        torch.cuda.synchronize()
    res["8B paged prefix-hit prefill s"] = m.prefill_seconds - secs
    res["8B paged prefix-hit prefill tok/s"] = (m.prefill_tokens - tokens) / (m.prefill_seconds
                                                                             - secs)
    del eng, params
    torch.cuda.empty_cache()


def train(torch, res):
    import numpy as np

    from flash_attn_tpu_torch.models import llama
    from flash_attn_tpu_torch.utils import train as tr

    cfg = dataclasses.replace(llama.LLAMA3_8B, num_layers=32)
    params = llama.init_params(cfg, seed=SEED, device="cuda")
    init_fn, step_fn = tr.make_train_step(
        lambda p, tokens, remat: llama.forward(p, tokens, cfg, remat=remat), tr.TrainConfig())
    state = init_fn(params)
    batch = np.random.default_rng(SEED + 14).integers(0, cfg.vocab_size, (1, 2049))
    batch = torch.from_numpy(batch).to("cuda")
    secs = []
    for _ in range(5):
        t0 = time.perf_counter()
        params, state, _ = step_fn(params, state, batch[:, :-1], batch[:, 1:])
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    res["train 8B ms/step"] = 1e3 * float(np.median(secs[1:]))
    del params, state
    torch.cuda.empty_cache()


def measure(tree: Path, models: str) -> None:
    sys.path.insert(0, str(tree))
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import flash_attn_tpu_torch

    assert Path(flash_attn_tpu_torch.__file__).resolve().is_relative_to(tree.resolve())
    res = {"tree": str(tree)}
    t0 = time.perf_counter()
    kernels(torch, res)
    torch.cuda.empty_cache()
    if models != "none":
        from flash_attn_tpu_torch.models import llama

        if models in ("all", "serve"):
            serve(torch, res, "8B int8 fp8-KV", llama.LLAMA3_8B, 32, quantize="int8")
            serve(torch, res, "8B w4a8 fp8-KV", llama.LLAMA3_8B, 32, quantize="w4a8",
                  group_size=128, head_mode="w8a8", fuse=True)
            serve(torch, res, "70B int4 fp8-KV", llama.LLAMA3_70B, 16, quantize="int4",
                  group_size=128, head_mode="w8a8", fuse=True)
        if models in ("all", "train"):
            train(torch, res)
        if models in ("all", "chunk"):
            chunk_paths(torch, res)
    res["seconds"] = time.perf_counter() - t0
    print("turn " + json.dumps(res), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", type=Path, help="another checkout of the repository")
    ap.add_argument("--order", default="OTTO")
    ap.add_argument("--models", choices=("all", "serve", "train", "chunk", "none"), default="all",
                    help="models measured after the kernels")
    ap.add_argument("--measure", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.measure:
        measure(args.measure, args.models)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    trees = {"T": ROOT, "O": args.other}
    turns = []
    for who in args.order:
        cmd = [sys.executable, str(Path(__file__).resolve()), "--measure", str(trees[who]),
               "--models", args.models]
        out = subprocess.run(cmd, capture_output=True, text=True)
        line = next((x for x in out.stdout.splitlines() if x.startswith("turn ")), None)
        if out.returncode != 0 or line is None:
            print(f"turn {who} failed:\n{out.stdout[-4000:]}\n{out.stderr[-4000:]}")
            return 1
        print(line, flush=True)
        turns.append((who, json.loads(line[5:])))
    keys = [k for k in turns[0][1] if k not in ("tree",)]
    print("metric | " + " | ".join(who for who, _ in turns))
    for key in keys:
        vals = [r.get(key) for _, r in turns]
        print(f"{key} | " + " | ".join(f"{x:.4f}" if isinstance(x, float) else str(x)
                                       for x in vals))
    return 0


if __name__ == "__main__":
    sys.exit(main())
