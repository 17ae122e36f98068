#!/usr/bin/env python3
"""Drive the PyTorch port (flash_attn_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, one line each with its seconds:
  1. environment: card name and power limit, CUDA, nvcc, kernel build time;
  2. each hand-written kernel against its plain PyTorch version on the card
     at its main-path shapes, with its time (CUDA events), its bound and
     the time of one PyTorch library call for the same function: K1 decode,
     K1m (the split-KV combine: bf16 and fp32 out, splits at -1e30 and
     -inf, an idle slot), K1c, the chunk kernel over a contiguous cache
     (T=5 at H=32 and 64, at the verify step's lengths at H=32 and 24, and a
     decode at G=16), K1 over a BSHD cache (through
     flash_attn_tpu_torch.flash_decode, JAX's default layout), K1 and K4 at
     the draft's H=24, K2 kv-append (bit for bit; its CUDA-graph time
     beside an empty kernel on its grid), K3 int8 matmul
     (8B shapes, M = 8 and 512, and 17, 100 and 4096), K4 flash forward
     (both softmax modes, also at S=891, a shifted Sq=1000 Sk=1500, B=2
     with per-sequence rope and H=24; with segment ids and positions at
     the packed prefill's shape, phase 4's eight prompts in 4096, and
     positions alone at a chunk's, Sq=512 at start 1024 over 4096, each
     timed alone and as called beside SDPA with the boolean mask and the
     bound on live pairs; and where the masks compose: segments + causal,
     random unsorted segments + positions, rows and blocks with no live
     key; each masked case's tile lists as the kernel counts them, held to
     the tile test), K8 paged
     decode (decode mode at pages of 128 and 512, with the live splits it
     plans, one launch that merges them in the kernel, also against K1 on
     the same content; graph and as-called times at phase 2's lengths and
     at the paged engine's), K8c, the chunk kernel over pages (T=128 at kv_len 640
     and 1024, a ragged T=123, T=4 in both softmax modes), K3 grouped, K6
     int4 matmul (70B
     shapes) and K5 W4A8 matmul (8B shapes), both at M = 8 and 256, at
     17-128 on w_gate_up, at 4096 (the packed bucket) on one shape and on
     an N tail (4096 x 6148), K7 W8A8 matmul (70B head, M = 8, 100, 1024,
     4096, bit-exact), K9 and K10 flash backward (dq and dk/dv passes, at the
     training shape, at a shifted causal Sq=1000, Sk=1500, non-causal at
     B=2, at group sizes 1 and 8 and non-causal at S=2048, each also
     launched twice and held bitwise equal, beside the device time of
     SDPA's backward); Gemma-2-9B's points: K4 at head_dim 256 (S=8192,
     H=16, Hk=8, causal, clamped, softcap 50, scale 1/16) with the sliding
     window (4095, -1) and without, timed, beside SDPA without the cap (no
     single PyTorch call applies the softcap), and at S=891 and a shifted
     Sq=1000 Sk=1500 in both modes, with a window of 300 and without; K1
     at head_dim 256 (B=8, H=16, Hk=8, capacity 8192, int8 and fp8,
     online, softcap 50, lengths up to 8000) with window 4096 and without,
     timed; K2 bit for bit and K1m at head_dim 256; K3 at Gemma-2-9B's five
     projection widths at M = 8; K9 and K10 at head_dim 256 (S=8192, H=16,
     Hk=8, causal, rope, softcap 50) with the window (4095, -1) and
     without, timed beside SDPA's backward without the cap, and at a
     ragged shifted Sq=1000 Sk=1500 and S=4200, just past the window,
     and at S=2048 where the cap bends (cap 5, windowed and causal),
     so that a kernel without the cap's 1 - t^2 factor or the cap fails;
     GPT-2 124M's points, head_dim 64, H = Hk = 12: K4 causal at B=1 and
     B=8, S=1024 (timed beside SDPA), a shifted Sq=300 Sk=1000 and q
     rotated in the kernel, in both modes; K4 with segment ids and
     positions at phase 12's prompts packed in their bucket and with
     positions at a chunk of 256 at 512 over 1024 (timed beside SDPA with
     the boolean mask; its tile counts held to the tile test's); K1 at B=8
     (bf16, int8, fp8) and B=1 over 1024 positions, K1m on its partials,
     K1c at T=5 (int8, fp8), one K8c point (T=128 over pages of 128), K2
     bit for bit, and K8 at pages of 128 (bf16, int8, fp8, against K1 on
     the same content); K9 and K10 at head_dim 64 (B=8, S=1024, H=Hk=12,
     causal, timed beside SDPA's backward; a ragged shifted Sq=1000
     Sk=1500 with GQA 12/4 and rope; non-causal at B=2 with rope);
     Gemma-2-27B's points, head_dim 128 (K4's, K9's and K10's kLocal
     instances beside Llama's), H=32, Hk=16, softcap 50, scale 1/12: K4
     at S=8192 causal and clamped with the window (4095, -1) and without
     (timed beside SDPA without the cap) and at S=891 and a shifted
     Sq=1000 Sk=1500 in both modes, with a window of 300 and without; K1
     fp8 at B=8, capacity 8192 with window 4096 and without; K3 at its
     five projection widths at M = 8; K9 and K10 at S=8192 with the window
     and without (timed), a ragged shifted windowed case, the cap-5 pair at
     S=2048 and non-causal with a two-sided window (8, 2); the plain
     versions of K4, K9 and K10 run over groups of heads where their score
     tensors would pass 4 GiB; Qwen-2-7B's 7 query heads a KV head (H=28,
     Hk=4, D=128), where a power-of-two group would show: K4 causal at
     S=2048 in both modes and packed with segment ids at phase 16's
     prompts in 4096 (its tile counts held), K1 (7 rows in its 8-row tile)
     at B=8, S=4096, int8 and fp8, K1c at T=5 (35 virtual rows), K8 in
     decode mode (R=7) and K8c at T=128 (896 rows), K2 at Hk=4 bit for
     bit, and K3 at Qwen-2-7B's widths at M = 8 and 512 with the qkv bias
     through quantized_matmul at the wq and wk/wv widths; Mistral-7B's
     window on the serving paths (check_mistral; H=32, Hk=8, D=128,
     window 4096): K4's masked kLocal instance with segment ids and
     positions at 8 prompts packed in 8192 (window (4095, -1) on the
     positions, clamped, timed beside SDPA with the window as a boolean
     mask; with cap 50, no library call; online) and a chunk of 512 at
     6000 over 8192 (its tile counts held to the tile test's), K1c at B=8,
     T=5 over 8192 positions, K8 in decode mode and K8c at T=128 over
     pages of 128 (lengths to 8000), int8 and fp8, each against its plain
     version, K8 also against K1's windowed decode; Mistral-7B's training
     kernels (check_mistral_train; the rows "K4 local seg idx", "K9 local
     seg", "K10 local seg"): four documents of 4800, 2000, 900 and 492
     packed in 8192 with segment ids alone, as llama.forward(segment_ids=)
     passes them, so the window (4095, -1) compares the indices: K4's
     masked kLocal twin, K9's and K10's kLocal and kOpt twin (each launched
     twice, bitwise), timed beside SDPA (and its backward) with the
     segments and the window as a boolean mask; then, checked only, the
     same row with positions given (the window on the positions) and with
     cap 5 on the indices; then once
     each what the main paths do not run: group sizes 32 and 64, K7's
     bf16 output, and the int8, int4 and W4A8 LM heads' fp32 activations
     or output; last, K11, the ring run in one cooperative launch, at
     Llama-3-8B's attention widths (H=32, Hk=8, D=128, B=1) over 4 ranks
     sharing the card, S_loc 4096 (16384 tokens), causal and not, fp32 and
     bf16 in, against its plain version and bitwise on repeat, timed beside
     SDPA's memory-efficient backend on the gathered fp32 sequence with its
     bound (three TF32 passes at the TF32 tensor-core peak; beside it the
     fp32 CUDA-core and bf16 tensor-core figures), and at a ragged S_loc
     320 (block_q 64) at B=2, a group of one at head_dim 64, 8 ranks, 1
     rank and large logits (q x 8, logits to ~40: one TF32 pass misses);
     then the rest of the FA2 surface (check_fa2_surface; rows "K4
     surface", "K9 surface", "K10 surface"): ALiBi in K4, K9 and K10 at
     Llama-3-8B's attention widths (H=32, Hk=8, D=128: MPT-7B's and
     BLOOM-7B1's heads and head_dim; B=1, S=2048, causal, rope,
     alibi_slopes(32)), at a shifted Sq=1000 Sk=1500, with packed documents
     and dropout 0.1, and at GPT-2's widths (B=8, S=1024, H=Hk=12, D=64,
     alibi_slopes(12), the interleaved schedule), timed beside SDPA with
     ALiBi as a float mask (forward and backward); dbias (K9 writing dS) at
     B=2, S=2048 with a [1, 32, S, S] bias summed over the batch, a [2, 1,
     S, S] one summed over the heads and dropout 0.1, beside SDPA's
     backward with the float mask requiring grad; return_softmax at the 8B
     prefill shape in both modes with and without dropout (rows summing to
     1, P @ V recomposing out, the entries above the diagonal 0); auto in
     range bitwise the clamped call with one launch, with q x32 bitwise the
     online call with two, with a bias through the clamped_verify flags,
     which equal the plain version's;
  3. a 2-layer model at full 8B widths with fp8 KV: two prompts and four
     decode steps on the card (kernels) against the CPU (plain versions),
     with int8 weights, int4 + W8A8 head fused, W4A8 + W8A8 head fused,
     int8 weights + int8 head, and int4 + int4 head fused; then the paged
     path (int8 weights): a prompt, a prompt sharing its first two pages
     through the suffix prefill, and four paged decode steps; the verify
     step (int8 weights): two prompts, then decode_multi of 5 tokens
     against the CPU and against five decode steps on the card; Gemma-2
     (2 layers at 9B widths, layer 0 sliding, layer 1 global, int8
     weights, fp8 KV, the window cut to 512): a 1000-token prompt and four
     decode steps against the CPU, and one training loss and every
     gradient (bf16, B=1, S=1024, remat) against the CPU; the same two at
     2 layers of Gemma-2-27B's widths (head_dim 128, q_dim 4096 against
     hidden 4608, scale 1/12); the
     prefill paths (int8 weights): prefill_packed of three prompts in the
     1024 bucket, and prefill_chunk of a 700-token prompt in chunks of 256
     into an fp8 cache (logits and the cache); then one
     training loss and every parameter's gradient (2 layers at 8B widths,
     bf16, B=1, S=128, remat); Mistral-7B's prefill, paged and verify
     rows at 2 layers of its widths with the window cut to 512 and prompts
     of about 1000 tokens (mistral_card_vs_cpu); GPT-2 (2 layers at 124M widths, bf16, int8
     KV): two prompts, four decode steps with an idle slot past
     max_position, decode_multi of 5 tokens, prefill_packed of three
     prompts, prefill_chunk in chunks of 256 and four paged decode steps
     against the CPU, and an fp32 model on the card must raise; one GPT-2
     training loss and every gradient (2 layers at 124M widths, bf16, B=1,
     S=1024, remat) against the CPU; the 8B runs with int8 weights (the
     prompts and decode steps, the prefill paths, the paged path, the
     verify step) again at 2 layers of Qwen-2-7B's widths (G = 7, the
     qkv bias); Mixtral at 2 layers of 8x7B's widths, int8 and int4
     g=128 experts and attention: two 256-token prompts and three decode
     steps, and each layer alone on the card fed the CPU's hidden state:
     per layer at most 1 % of tokens may choose another top-2 expert set,
     and the layer's output (the logits for the last) on the agreeing
     tokens within 5 %; the end-to-end flips and logits printed; one
     Mixtral training loss (the whole forward, 1e-3) and every gradient
     (2 layers at 8x7B widths, bf16, B=1, S=128, remat), the gradients
     piece by piece, each piece on the card fed the CPU's input and the
     CPU's gradient at its output (the head; each layer alone, a token
     whose top-2 set differs given zero upstream gradient on both sides,
     at most 1 % of a layer's tokens; the embedding), each to 5e-2 of its
     norm; one Mistral-7B training loss and every gradient (2 layers at
     its widths, the window cut to 256, B=1, S=1024 holding documents of
     600, 250 and 174, the window on the indices); LoRA
     (2 layers at 8B widths, int8 fused, a bank of 4 rank-16 adapters,
     fp32): 8 prompts prefilled two a call under lora_id 0-3, then four
     decode steps with per-slot ids [0, 1, 2, 3, 0, 1, 2, 3], against the
     CPU;
  4-6. the main paths, each model alone on the card, served by the
     continuous-batching engine (8 greedy requests, prompts of 128-1024
     tokens from the seed) with its decode bodies replayed from CUDA
     graphs, with the launch count of every kernel in each run (replays
     counted; the 8 prompts go through one packed prefill, whose K4 calls
     carry segment ids, one a layer): 4. Llama-3-8B int8 weights, fp8 KV
     three ways, eager (disable_graphs()), captured, and captured at
     decode_burst 4, whose tokens must be equal (64 tokens), then the same
     prompts one prompt a prefill call (16 tokens) and with
     prefill_chunk_size 512 (4c, 32 tokens: K4 with positions one a layer
     and chunk), with the prefill tokens/s of the three, then int8 KV (32
     tokens); each with
     its ms a decode position after the warm-up and capture, decode
     tokens/s, the card's ms a position (the captured graph replayed back
     to back) and the host's (the rest), and the card's idle share in a
     torch.profiler window of 8 steady steps (eager and captured: 1 - the
     union of the card's activity intervals over the window) with the top
     5 kernels; then a captured stochastic run (temperature 0.8, top_k 50,
     8 tokens, two seeds twice each: valid tokens, equal for one seed),
     and one engine whose head changes in place between two waves (2
     layers): it must re-capture and match a fresh eager engine;
     5. Llama-3-8B W4A8 layers + W8A8 head, fused, fp8 KV (32 tokens);
     6. Llama-3-70B (80 layers, random weights from the seed) int4 g=128
     layers + W8A8 head, fused, fp8 KV, three ways as phase 4 (32 tokens;
     the captured window only), with its peak memory against 75 GiB;
  7. (run right after phase 4, on its params) Llama-3-8B int8 weights
     served by the paged engine with prefix caching, fp8 KV, pages of
     128, captured: two waves of 8 requests sharing a 512-token prefix,
     the first all misses, the second all hits that prefill only their
     suffixes; each decode-mode K8 call must be one launch that merges its
     own splits (K1m serves only K8c); then again at decode_burst 4, whose
     tokens must equal decode_burst 1's;
  9. (run right after phase 7, on phase 4's params) speculative decoding,
     4 drafts per round, draft scans and verify steps captured, the same 8
     prompts and 32 tokens: (a) n-gram drafts, fp8 KV; (b) a self-draft
     with bf16 KV, whose acceptance must reach 0.5; (c) a draft at
     Llama-3.2-3B widths (bf16, random from the seed), fp8 KV; each with
     tokens/s, ms per round, tokens per verify step, acceptance, the
     launches (K1's chunk mode 32 per verify round) and its tokens against
     phase 4's captured run;
  10. (run after phase 6) Gemma-2-9B (42 layers, random weights from the
     seed), int8 weights, fp8 KV, capacity 8192: 8 greedy requests (seven
     prompts of 128-1024 tokens and one of 6000, so the 4096 window cuts in
     prefill and decode), 32 tokens, one prompt a prefill call, eager and
     captured (equal tokens): decode ms a position and tokens/s, the
     card's ms a position, prefill tokens/s, peak memory against 75 GiB,
     and the launches (K4 at head_dim 256 42 a prefill call, 21 of them
     windowed; K1 at 256, K2 and K1m 42 a decode step); then int8 KV (16
     tokens);
  14. (run right after phase 10) Gemma-2-27B (46 layers, head_dim 128,
     random weights from the seed), int8 weights, fp8 KV, as phase 10
     without the int8 KV run: K4 46 a prefill call, all on its head_dim 128
     kLocal instance, 23 windowed; K1, K2 and K1m 46 a step, 23 of K1's
     windowed; peak under 75 GiB;
  8. training: Llama-3-8B at full widths and depth (bf16 params, AdamW
     moments in bf16), B=1, S=2048, the default TrainConfig (remat on), 5
     AdamW steps on one seeded batch: losses, ms per step, tokens/s, peak
     memory, and the launches of K4, K9 and K10;
  11. training: Gemma-2 at full 9B widths, 8 layers (4 sliding, 4
     global), B=1, S=8192, as phase 8: K9 = K10 = 8 a step, 4 of them
     windowed, K4 16 (remat reruns it), peak under 75 GiB;
  15. (run right after phase 11) training: Gemma-2 at full 27B widths, 4
     layers (2 sliding, 2 global), B=1, S=8192: K9 = K10 = 4 a step and K4
     8, all on the head_dim 128 kLocal instances, half windowed; the
     median step beside its bound; peak under 75 GiB;
  12. GPT-2 124M (12 layers, 12 heads of 64, bf16 weights from the seed),
     capacity 1024, 8 greedy prompts of 64-512 tokens, 64 tokens each, one
     prompt a prefill call: int8 KV eager, captured and at burst 4 (equal
     tokens), fp8 KV eager and captured (equal tokens), chunks of 256,
     packed (capacity 4096), paged and n-gram speculation (first tokens
     equal to the captured run's, agreement printed), each with the
     launches at head_dim 64 (K4 12 a prefill call; K1, K2, K1m 12 a
     decode step; K1c 12 a verify round; K8 12 a paged step); then
     BASELINE config 0: batch 1, int8 KV, 960 + 64 = 1024 positions; then
     the perplexity line: utils/ppl.kv_ppl_delta on the same params, the
     960-token prompt and 64 tokens from the seed, bf16, int8 and fp8 KV
     (each |delta ppl| under 5 % of the bf16 cache's);
  13. (run right after phase 12) training: GPT-2 124M at full depth (bf16
     params and moments from the seed), B=8, S=1024, 5 AdamW steps (remat
     on): losses finite and falling, ms per step beside its bound (the
     fp32 products at 67 TFLOP/s and attention at 989), tokens/s, peak
     memory, and K9 = K10 = 12 a step, K4 24, all at head_dim 64;
  16. Qwen-2-7B (28 layers, 28 query heads over 4 KV heads, the qkv
     bias; random weights from the seed), int8 weights, fp8 KV, capacity
     4096, phase 4's prompts: eager, captured and burst 4 (equal tokens),
     one prompt a prefill call and chunks of 512 beside the packed call,
     the paged engine with prefix caching (two waves), n-gram
     speculation; launches exact (K4 28 a packed call, K1 = K2 = K1m 28
     a step, K1c 28 a verify round, K8 28 a paged step), peak printed;
  17. Mixtral-8x7B (32 layers, 8 experts, top 2; random weights drawn
     and quantized one projection at a time), int8 experts and
     attention, fp8 KV, capacity 4096, phase 4's prompts in one packed
     call: eager and captured (equal tokens) with the card's share and
     the profiler window's idle share, n-gram speculation, the paged
     engine without prefix caching; launches exact (K3 = 32 x (4 + 3 x
     8) = 896 a step, K1 = K2 = K1m 32 a step, K4 32 a packed call, K1c
     32 a verify round, K8 32 a paged step), peak under 75 GiB;
  25. (run right after phase 17) Mistral-7B-v0.1's published config at
     full size (32 layers, window 4096; random int8 weights), fp8 KV,
     capacity 8192, max_batch 8, 32 tokens: two groups of four prompts
     (4200 and 4300 past the window, each group one packed call) eager
     and captured (equal tokens), chunks of 512, the paged engine with
     prefix caching (a 4096-token prefix, two waves of 8, hits printed),
     n-gram speculation; launches exact on the windowed instances (K4's
     masked kLocal 32 a packed call or chunk, K1 32 a step, K1c 32 a
     verify round, K8 32 a paged step, K8c 32 a suffix piece of 128),
     ms a position, prefill tokens/s and the peak;
  24. (run right after phase 25) training: Mixtral at 8x7B widths, 2 of
     its 32 layers (bf16 params and moments from the seed), B=1, S=2048, 5
     AdamW steps (remat on) through mixtral.forward: losses finite and
     falling, ms per step beside its bound, tokens/s, peak under 75 GiB,
     K9 = K10 = 2 a step and K4 4; the state saved after step 3 by
     utils/checkpoint.TrainCheckpointManager and restored bit for bit, the
     restored state's steps 4-5 against the straight run's; then 2 steps
     on phase 19's packed documents (K4 masked, K9 and K10 kOpt), launches
     exact;
  26. (run right after phase 24) training: Mistral-7B-v0.1's published
     config at full size (32 layers, window 4096; bf16 params and moments
     from the seed), B=1, S=8192 holding four documents of 4800, 2000, 900
     and 492 (segment ids 1-4, positions restarting for RoPE; the first
     past the window), 5 AdamW steps (remat on) through
     llama.forward(segment_ids=): losses finite and falling, ms a step
     (median of steps 2-5) beside its bound, tokens/s, peak under 75 GiB,
     launches exact (K4's masked kLocal twin 64 a step, K9's and K10's
     kLocal and kOpt twin 32 each);
  20. (run right after phase 18) sequence-parallel attention at
     Llama-3-8B's attention widths, B=1, 16384 tokens over 4 ranks sharing
     the card (make_mesh with cuda:0 four times; every rotation a
     device-local copy, so the times say nothing about NVLink): the ring
     over K4 / K9 + K10, contiguous and striped, causal, forward and
     backward through autograd, the rdma ring (K11) forward and Ulysses
     forward and backward, each against the single-device
     flash_attention on the whole sequence (rows to two bf16 ulps,
     gradients to 5e-2 of their norm), the rdma ring also against the
     ring, with launches a call exact (K4 = K9 = K10 = 10 contiguous, 16
     striped, 4 Ulysses; K11 1) and ms a call; the contiguous ring with
     the window (4095, -1) on the global positions against one windowed
     call (K4's masked kLocal instance and K9's and K10's kLocal and kOpt
     instances 10 each);
  21. (run last) multi-adapter LoRA serving: Llama-3-8B int8 fused, fp8
     KV, capacity 4096, phase 4's prompts one a prefill call, 32 tokens,
     a bank of 4 rank-16 adapters (alpha 32, all seven linear layers,
     fp32; adapter 0's B = 0, adapters 1-3 at 10 % of the base projection's
     rms at layer 0), request i on adapter i % 4: the base without a bank
     and the bank, each eager and captured (decode ms a position, tokens/s,
     the card's ms, prefill tokens/s, the bank's bytes, peak), every
     request on adapter 1, then the same requests over HTTP
     (serving.serve: 8 concurrent /generate, /stream, one /generate timed
     beside the engine's own seconds, /health, /submit + /cancel); adapter
     0 must equal the base, adapters 1-3 change tokens, requests 1 and 5
     equal across the mixed and all-adapter-1 runs, eager equal captured,
     HTTP equal direct, and the launches exact (K4 32 a prompt, K1 = K2 =
     K1m 32 a step, K3 128 a prefill call or step);
  22. (run right after phase 20) the FA2 surface through the public entry
     points: flash_attention with ALiBi forward and backward under
     autograd (8B attention widths, B=1, S=2048, causal, rope), with a
     [1, 32, 2048, 2048] mask that requires grad (B=2), return_softmax,
     softmax_mode "auto" in range and with q x32, with and without a mask;
     flash_attention_varlen at GPT-2's widths (8 sequences in 4096) with
     return_softmax and a mask that requires grad; the ring (4 ranks of
     S_loc 1024 on one card, contiguous and striped) with a [1, 32, 4096,
     4096] bias that requires grad against the single call; each against
     the plain versions on the card, launches exact (ALiBi, probs, verify
     and dS counted apart) and a kernels line with their sums;
  23. BASELINE configs 3 and 4 on logical ranks of the card (run last, 23b
     right after phase 6 on its params): 23a Llama-3-8B int8, fp8 KV,
     capacity 131072 sharded over sp=4 (each rank's 32768 positions a
     view of the one cache buffer, read in place by K1's view instances),
     max_batch 2, prompts of 36000 and 1000 tokens in chunks of 4096:
     16 teacher-forced steps of decode_step_sharded against decode_step
     from the same cache state (phase 3's rule; one step's launches K1 4
     x 32, all view, K1m 32, K2 32), eager ms a position of both, then
     the mesh engine captured (launches exact) and the unsharded engine,
     their greedy tokens' agreement printed, peaks; 23b Llama-3-70B int4
     g=128 + W8A8 head unfused and sharded at tp=4 layer by layer:
     teacher-forced against tp=1 (phase 3's rule on 2 layers; 80 layers
     printed beside the fused tree's own spread), K6 and K7 launches a
     step 4x tp=1's, served captured (ms a position, peak under 75 GiB);
     23c moe_ffn_ep and moe_ffn_ep_a2a at Mixtral's widths over tp=4
     against moe_ffn_reference, pipeline_spmd over 4 stages against the
     stages in sequence.  Phase 2 holds K1 on the 4 shard views of a [8,
     8, 16384, 128] fp8 cache bitwise against K1 on contiguous copies,
     the K1m merge against the plain merge and the single call ("K1
     shard"), and K6 and K7 at 70B's tp=4 slices ("K6 tp4", its slices
     under "slices"; "K7 tp4").

Before the last line come the kernels' JSON record (each row's launches
are those of the run named in its "launches_run"; the quantized matmuls'
rows also carry their prompt bucket's numbers under "prompt", K4's its
packed and chunk points under "packed" and "chunk", K3's Gemma-2-9B
widths under "gemma"; the head_dim 256 rows "K4 d256" and "K1 d256"
carry the unwindowed call under "no_window" and SDPA without the softcap
under "sdpa_nocap_ms", as do "K9 d256" and "K10 d256" and Gemma-2-27B's
rows "K4 27B", "K1 27B", "K9 27B" and "K10 27B"; K3's 27B widths under
"gemma27b"; "K4 d64" its
masked points under "packed" and "chunk", "K1c d64" a K8c point under
"k8c"; the G = 7 rows "K4 G7" (its packed point under "packed"), "K1
G7", "K1c G7", "K8 G7" (a K8c point under "k8c") and "K2 G7", K3's
Qwen-2-7B widths under "qwen2", "K3 Mixtral", whose launches are
phase 17's, and "K11", its non-causal point under "non_causal", its
bound at the fp32 CUDA-core and bf16 peaks under "bound_f32_ms" and
"bound_bf16_ms", its launches phase 20's; "K4 surface", "K9 surface" and
"K10 surface" their GPT-2 point under "gpt2", K4's return_softmax and
clamped_verify points under "probs" and "verify", K9's and K10's dbias
point under "dbias", their launches phase 22's; Mistral-7B's windowed
rows "K4 local seg" (its cap-50 point under "softcap", its chunk under
"chunk"), "K1c window", "K8 window" and "K8c window", their launches
phase 25's; Mistral-7B's training rows "K4 local seg idx", "K9 local seg"
and "K10 local seg", their launches phase 26's)
and the card; the last line is {"ok": true, "device": {...}}.  Any failed check
exits nonzero without that line; so does a machine without CUDA or a
directory without the rest of the repository.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
BF16_FLOPS_PER_S = 989e12      # H100 SXM dense bf16 tensor cores
F32_FLOPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12      # H100 SXM dense TF32 tensor cores
INT8_OPS_PER_S = 1979e12       # H100 SXM dense int8 tensor cores
MAX_70B_GIB = 75.0             # the 70B serve fails above this peak
MAX_TRAIN_GIB = 75.0           # the training run fails above this peak
TRAIN_LAYERS, TRAIN_SEQ, TRAIN_STEPS = 32, 2048, 5
TRAIN_LOSS_TOL = 1e-3          # phase 3 training, card vs CPU (see there)
TRAIN_GRAD_TOL = 5e-2
SEED = 0
# Gemma-2's attention softcap, 9B's scale (256^-1/2) and window; 27B's
# scale (query_pre_attn_scalar 144 at head_dim 128)
GEMMA_CAP, GEMMA_SCALE, GEMMA_WINDOW = 50.0, 256.0 ** -0.5, 4096
GEMMA27_SCALE = 144.0 ** -0.5


def say(msg: str) -> None:
    print(msg, flush=True)


def bound(nbytes: float, flops: float, peak: float = BF16_FLOPS_PER_S):
    """(least ms, what bounds it): bytes over the HBM rate against
    operations over ``peak`` (bf16, or int8 for the int8-activation
    kernels)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def row_err(got, ref, rel=2.0 ** -6, floor=1e-6):
    """(max |got - ref|, worst share of its row's tolerance).

    A row is one output vector (a query's head, a product's row).  Its
    tolerance is ``rel`` of its largest |ref|.  For a bf16 output that is
    two bf16 ulps (2^-6): the kernel and its plain version differ by the
    bf16 rounding of the output and of fp32 values summed in another order,
    at most one ulp of an element, and no element's ulp exceeds 2^-7 of the
    row's largest.  An fp32 output of exact products (fp32 x in three bf16
    parts, or int8 x) differs only by fp32 sums in another order, far below
    its ``rel`` of 2^-16; rounding x to one bf16 part would miss it by ~2^-11.
    A long attention row has small outputs, so a tolerance taken from the
    whole tensor's largest value (a short row's) would not see a lost or
    doubled tile there.  ``floor`` is an absolute tolerance added to every
    row's: a number, or one per row (a tensor shaped like ``ref`` without its
    last dimension, or with it as 1)."""
    g = got.float().reshape(-1, got.shape[-1])
    r = ref.float().reshape(-1, ref.shape[-1])
    err = (g - r).abs()
    if hasattr(floor, "reshape"):
        floor = floor.float().reshape(-1, 1)
    tol = rel * r.abs().amax(dim=-1, keepdim=True) + floor
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


def plain_merge(outs, lses, dtype):
    """Plain partials merged by the plain version of K1m (ops/lse.py:
    lse_merge), as merge_splits merges them on the CPU: the references
    below never go through a kernel."""
    from flash_attn_tpu_torch.ops.lse import lse_merge

    if outs.shape[0] == 1:
        return outs[0].to(dtype), lses[0]
    out, lse = lse_merge(outs, lses, axis=0)
    return out.to(dtype), lse


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


def graph_ms(torch, fn, per_graph=10, replays=20) -> float:
    """The device's time for one call of ``fn``: ``per_graph`` calls
    captured in a CUDA graph, replayed ``replays`` times, so no host work
    sits between the kernels (for a kernel shorter than its wrapper's host
    work, which a loop of calls from Python would time instead)."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    return cuda_ms(torch, graph.replay, iters=replays, warmup=2) / per_graph


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


def _q_point(torch, checks, label, run, plain, lib=None, lib_name="", nbytes=0, flops=0,
             peak=BF16_FLOPS_PER_S, exact=False, graph=False):
    """One quantized matmul against its plain version: every output row
    within its tolerance (``exact``: bit for bit), its time by CUDA events
    and, where ``lib`` is given, the plain version's time (fewer launches:
    it is slow and only a reference), the library call's and the bound;
    with ``graph`` also the kernel's and the library call's times from
    CUDA-graph replays (no host work between launches).  Returns a row's
    numbers."""
    got = run()
    ref = plain()
    torch.cuda.synchronize()
    if exact:
        err = float((got.float() - ref.float()).abs().max())
        ok = checks.check(f"{label} bit-exact", err, 0.0)
        what = "tol 0, bit-exact"
    else:
        err, share = row_err(got, ref)
        ok = checks.check(label, share, 1.0)
        what = f"{share:.3f} of its row's tol"
    del got, ref
    res = dict(max_abs_err=err, ms=cuda_ms(torch, run))
    line = f"  {label}: max_abs_err {err:.3e} ({what}) {'ok' if ok else 'FAIL'} | {res['ms']:.4f} ms"
    if lib is not None:
        res["plain_ms"] = cuda_ms(torch, plain, iters=3, warmup=1)
        res["library_ms"] = cuda_ms(torch, lib)
        res["bound_ms"], res["bound_by"] = bound(nbytes, flops, peak)
        line += (f", plain {res['plain_ms']:.4f}, library ({lib_name}) {res['library_ms']:.4f}, "
                 f"bound {res['bound_ms']:.4f} ({res['bound_by']})")
        if graph:
            res["graph_ms"], res["library_graph_ms"] = graph_ms(torch, run), graph_ms(torch, lib)
            line += (f"; graph {res['graph_ms']:.4f}, library graph {res['library_graph_ms']:.4f}"
                     f" (ours / library {res['graph_ms'] / res['library_graph_ms']:.3f})")
    say(line)
    return res


def _q_row(name, replaces, points, main, prompt):
    """A kernel row: the main-path decode point's numbers, the prompt
    bucket's beside them, and the worst error over every point."""
    row = dict(name=name, source="flash_attn_tpu_torch/csrc/matmul_q.cu", replaces=replaces,
               max_abs_err=max(p["max_abs_err"] for p in points.values()))
    row.update({k: points[main][k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                              "bound_by")})
    row["prompt"] = dict(M=prompt[0], **{k: points[prompt][k] for k in (
        "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")})
    return row


def check_k3(torch, checks, rows):
    """K3 at the 8B shapes, M = 8 (decode) and 512, and at M = 17 and 100
    (rows that fill no whole 64- or 128-row block) and PACKED_M (the
    packed prefill's bucket, timed: Mixtral-8x7B's packed prefill runs its
    experts there) on 4096 x 14336."""
    from flash_attn_tpu_torch.ops import matmul as mm
    from flash_attn_tpu_torch.ops.quant import quantize_int8

    g = torch.Generator(device="cuda").manual_seed(SEED)
    points = {}
    for (K, N) in ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096)):
        wf = torch.randn((K, N), generator=g, device="cuda", dtype=torch.bfloat16) * 0.02
        wq, s = quantize_int8(wf, dims=(0,))
        wq, s = wq.contiguous(), s[0].contiguous()
        del wf
        wbf = wq.bfloat16()
        for M in (8, 512) + ((17, 100, PACKED_M) if (K, N) == (4096, 14336) else ()):
            x = torch.randn((M, K), generator=g, device="cuda", dtype=torch.bfloat16)
            timed = M in (8, 512, PACKED_M)
            points[(M, K, N)] = _q_point(
                torch, checks, f"K3 M={M} K={K} N={N}",
                lambda: mm.matmul_int8_cuda(x, wq, s, torch.bfloat16),
                lambda: mm.matmul_int8_plain(x, wq, s, torch.bfloat16),
                (lambda: torch.matmul(x, wbf) * s) if timed else None, "matmul, then the scales",
                M * K * 2 + K * N + N * 4 + M * N * 2, 2 * M * K * N)
        del wq, s, wbf
    rows["K3"] = _q_row("int8_matmul (M=8, K=4096, N=14336)", "flash_attn_tpu/ops/matmul.py:60",
                        points, (8, 4096, 14336), (512, 4096, 14336))
    # Mixtral-8x7B's experts (4096 x 14336, 14336 x 4096) and attention
    # (4096 x 4096, 4096 x 1024) have the 8B's widths: the same points, its
    # prompt the packed prefill's bucket
    rows["K3 Mixtral"] = _q_row("int8_matmul (M=8, K=4096, N=14336: a Mixtral-8x7B expert's "
                                "w_gate / w_up)", "flash_attn_tpu/ops/matmul.py:60", points,
                                (8, 4096, 14336), (PACKED_M, 4096, 14336))


def _int4_weight(torch, g, K, N, gs=128):
    """A random [K, N] weight quantized to int4, group size ``gs``."""
    from flash_attn_tpu_torch.ops.quant import quantize_int4

    wf = torch.randn((K, N), generator=g, device="cuda", dtype=torch.bfloat16) * 0.02
    w = quantize_int4(wf, group_size=gs)
    del wf
    return w


def _int8_grouped_weight(torch, g, K, N, gs):
    """A random [K, N] weight as int8 with [K/gs, N] scales, and its bf16
    dequantization."""
    from flash_attn_tpu_torch.ops.quant import quantize_int8

    wf = torch.randn((K // gs, gs, N), generator=g, device="cuda", dtype=torch.bfloat16) * 0.02
    w, s = quantize_int8(wf, dims=(1,))
    w, s = w.reshape(K, N).contiguous(), s[:, 0].contiguous()
    wdq = (w.float().reshape(K // gs, gs, N) * s[:, None, :]).reshape(K, N).bfloat16()
    return w, s, wdq


# M at which K6 and K5 are also checked on their fused gate+up shape: rows
# that fill no whole block (17, 100) and the prompt buckets below 256
_EXTRA_M = (17, 32, 64, 100, 128)
# an N that is not a multiple of the kernels' 128 columns (nor of 16)
_TAIL = (4096, 6148)
# the packed prefill's bucket: phase 4's eight prompts (3450 tokens) in 4096
PACKED_M = 4096


def check_k6(torch, checks, rows):
    """K6 at the 70B fused shapes (wqkv, wo, w_gate_up, w_down), g = 128,
    at decode (M = 8) and the largest prompt bucket that reaches it (256),
    at _EXTRA_M on w_gate_up, at PACKED_M on wo (the plain version's
    per-group partials at w_gate_up would take 60 GB), and on the N tail
    at M = 8, 17, 100, 256."""
    from flash_attn_tpu_torch.ops import matmul as mm
    from flash_attn_tpu_torch.ops.quant import dequantize_int4

    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    points = {}
    for (K, N) in ((8192, 10240), (8192, 8192), (8192, 57344), (28672, 8192), _TAIL):
        w = _int4_weight(torch, g, K, N)
        wdq = dequantize_int4(w, torch.bfloat16)
        ms = (8, 17, 100, 256) if (K, N) == _TAIL else (8, 256)
        ms += _EXTRA_M if (K, N) == (8192, 57344) else ()
        for M in ms + ((PACKED_M,) if (K, N) == (8192, 8192) else ()):
            x = torch.randn((M, K), generator=g, device="cuda", dtype=torch.bfloat16)
            args = (x, w.packed, w.scales, 128, torch.bfloat16)
            timed = M in (8, 256) and (K, N) != _TAIL
            points[(M, K, N)] = _q_point(
                torch, checks, f"K6 M={M} K={K} N={N}", lambda: mm.matmul_int4_cuda(*args),
                lambda: mm.matmul_int4_plain(*args),
                (lambda: torch.matmul(x, wdq)) if timed else None,
                "matmul on the bf16-dequantized weight",
                M * K * 2 + K * N // 2 + w.scales.numel() * 4 + M * N * 2, 2 * M * K * N)
        del w, wdq
    rows["K6"] = _q_row("int4_matmul (M=8, K=8192, N=57344, g=128)",
                        "flash_attn_tpu/ops/matmul.py:187", points, (8, 8192, 57344),
                        (256, 8192, 57344))


def check_k5(torch, checks, rows):
    """K5 at the 8B fused shapes, g = 128, M = 8 and 256, at _EXTRA_M on
    w_gate_up, at PACKED_M on wqkv, and on the N tail at M = 8, 17, 100,
    256; x is quantized per token by the port's plain
    quantize_activations first."""
    from flash_attn_tpu_torch.ops import matmul as mm
    from flash_attn_tpu_torch.ops.quant import dequantize_int4

    g = torch.Generator(device="cuda").manual_seed(SEED + 6)
    points = {}
    for (K, N) in ((4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096), _TAIL):
        w = _int4_weight(torch, g, K, N)
        wdq = dequantize_int4(w, torch.bfloat16)
        ms = (8, 17, 100, 256) if (K, N) == _TAIL else (8, 256)
        ms += _EXTRA_M if (K, N) == (4096, 28672) else ()
        for M in ms + ((PACKED_M,) if (K, N) == (4096, 6144) else ()):
            x = torch.randn((M, K), generator=g, device="cuda", dtype=torch.bfloat16)
            xq, sx = mm.quantize_activations(x)
            args = (xq, sx, w.packed, w.scales, 128, torch.bfloat16)
            timed = M in (8, 256) and (K, N) != _TAIL
            points[(M, K, N)] = _q_point(
                torch, checks, f"K5 M={M} K={K} N={N}", lambda: mm.matmul_w4a8_cuda(*args),
                lambda: mm.matmul_w4a8_plain(*args),
                (lambda: torch.matmul(x, wdq)) if timed else None,
                "bf16 matmul on the dequantized weight",
                M * K + M * 4 + K * N // 2 + w.scales.numel() * 4 + M * N * 2, 2 * M * K * N,
                INT8_OPS_PER_S)
        del w, wdq
    rows["K5"] = _q_row("w4a8_matmul (M=8, K=4096, N=28672, g=128)",
                        "flash_attn_tpu/ops/matmul.py:588", points, (8, 4096, 28672),
                        (256, 4096, 28672))


def check_k7(torch, checks, rows):
    """K7 at the 70B head (8192 x 128256) on fp32 activations, M = 8
    (decode), 100, 1024 and PACKED_M (the packed prefill's bucket):
    bit-exact against the plain version, whose int32 dot is exact in
    float64."""
    from flash_attn_tpu_torch.ops import matmul as mm
    from flash_attn_tpu_torch.ops.quant import quantize_int8

    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    K, N = 8192, 128256
    wf = torch.randn((K, N), generator=g, device="cuda", dtype=torch.bfloat16) * 0.02
    w, sw = quantize_int8(wf, dims=(0,))
    w, sw = w.contiguous(), sw[0].contiguous()
    del wf
    wbf = w.to(torch.bfloat16)
    points = {}
    for M in (8, 100, 1024, PACKED_M):
        x = torch.randn((M, K), generator=g, device="cuda", dtype=torch.float32)
        xq, sx = mm.quantize_activations(x)
        args = (xq, sx, w, sw, torch.float32)
        if M > 16:  # torch._int_mm's shape rule
            lib_name, lib_fn = "torch._int_mm", lambda: torch._int_mm(xq, w)
        else:
            xb = x.to(torch.bfloat16)
            lib_name, lib_fn = "bf16 matmul on the int8 values", lambda: torch.matmul(xb, wbf)
        points[(M, K, N)] = _q_point(
            torch, checks, f"K7 M={M} K={K} N={N}", lambda: mm.matmul_w8a8_cuda(*args),
            lambda: mm.matmul_w8a8_plain(*args), lib_fn if M in (8, 1024) else None, lib_name,
            M * K + M * 4 + K * N + N * 4 + M * N * 4, 2 * M * K * N, INT8_OPS_PER_S, exact=True)
    del w, wbf
    rows["K7"] = _q_row("w8a8_matmul (M=8, K=8192, N=128256, fp32 out)",
                        "flash_attn_tpu/ops/matmul.py:488", points, (8, K, N), (1024, K, N))


def check_k3g(torch, checks, rows):
    """K3 grouped at 4096 x 14336, g = 128, M = 8, 17, 100 and 256 (no
    model mode makes grouped int8 scales, so this phase is its only
    caller)."""
    from flash_attn_tpu_torch.ops import matmul as mm

    g = torch.Generator(device="cuda").manual_seed(SEED + 8)
    K, N, gs = 4096, 14336, 128
    w, s, wdq = _int8_grouped_weight(torch, g, K, N, gs)
    points = {}
    for M in (8, 17, 100, 256):
        x = torch.randn((M, K), generator=g, device="cuda", dtype=torch.bfloat16)
        args = (x, w, s, gs, torch.bfloat16)
        points[(M, K, N)] = _q_point(
            torch, checks, f"K3 grouped M={M} K={K} N={N} g={gs}",
            lambda: mm.matmul_int8_grouped_cuda(*args),
            lambda: mm.matmul_int8_grouped_plain(*args),
            (lambda: torch.matmul(x, wdq)) if M in (8, 256) else None,
            "matmul on the bf16-dequantized weight",
            M * K * 2 + K * N + s.numel() * 4 + M * N * 2, 2 * M * K * N)
    rows["K3g"] = _q_row("int8_matmul grouped (M=8, K=4096, N=14336, g=128)",
                         "flash_attn_tpu/ops/matmul.py:133", points, (8, K, N), (256, K, N))


def check_variants(torch, checks):
    """What the main paths do not run, each checked once: K3 grouped, K6
    and K5 at g = 32 and 64, and K7 with a bf16 output, at the 8B wqkv
    shape (4096 x 6144) with M = 8 (split K) and 256; the LM heads of the
    other modes at the 8B head (4096 x 128256), whose activations are
    fp32: K3 (int8 head) and K6 (int4 head) on fp32 x in three bf16 parts,
    K5 (W4A8 head) with an fp32 output."""
    from flash_attn_tpu_torch.ops import matmul as mm
    from flash_attn_tpu_torch.ops.quant import quantize_int8

    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    bf, f32 = torch.bfloat16, torch.float32

    def run(label, fn, plain, rel):
        got, ref = fn(), plain()
        torch.cuda.synchronize()
        if rel:
            err, share = row_err(got, ref, rel)
            ok = checks.check(label, share, 1.0)
            what = f"{share:.3f} of its row's tol, {rel:g} of the row's largest"
        else:
            err = float((got.float() - ref.float()).abs().max())
            ok = checks.check(label, err, 0.0)
            what = "tol 0, bit-exact"
        ms = cuda_ms(torch, fn)
        say(f"  {label}: max_abs_err {err:.3e} ({what}) {'ok' if ok else 'FAIL'} | {ms:.4f} ms")

    def per_column_int8(K, N):
        wf = torch.randn((K, N), generator=gen, device="cuda", dtype=bf) * 0.02
        w, s = quantize_int8(wf, dims=(0,))
        return w.contiguous(), s[0].contiguous()

    K, N = 4096, 6144
    for gs in (32, 64):
        w8, s8, _ = _int8_grouped_weight(torch, gen, K, N, gs)
        w4 = _int4_weight(torch, gen, K, N, gs)
        for M in (8, 256):
            x = torch.randn((M, K), generator=gen, device="cuda", dtype=bf)
            xq, sx = mm.quantize_activations(x)
            a = (x, w8, s8, gs, bf)
            run(f"K3 grouped g={gs} M={M} K={K} N={N}", lambda: mm.matmul_int8_grouped_cuda(*a),
                lambda: mm.matmul_int8_grouped_plain(*a), 2.0 ** -6)
            a = (x, w4.packed, w4.scales, gs, bf)
            run(f"K6 g={gs} M={M} K={K} N={N}", lambda: mm.matmul_int4_cuda(*a),
                lambda: mm.matmul_int4_plain(*a), 2.0 ** -6)
            a = (xq, sx, w4.packed, w4.scales, gs, bf)
            run(f"K5 g={gs} M={M} K={K} N={N}", lambda: mm.matmul_w4a8_cuda(*a),
                lambda: mm.matmul_w4a8_plain(*a), 2.0 ** -6)
    w, sw = per_column_int8(K, N)
    for M in (8, 256):
        xq, sx = mm.quantize_activations(torch.randn((M, K), generator=gen, device="cuda", dtype=bf))
        a = (xq, sx, w, sw, bf)
        run(f"K7 bf16 out M={M} K={K} N={N}", lambda: mm.matmul_w8a8_cuda(*a),
            lambda: mm.matmul_w8a8_plain(*a), 0.0)
    del w8, s8, w4, w, sw

    K, N = 4096, 128256
    w, sw = per_column_int8(K, N)
    for M in (8, 1024):
        x = torch.randn((M, K), generator=gen, device="cuda", dtype=f32)
        run(f"K3 fp32 x, fp32 out M={M} K={K} N={N}", lambda: mm.matmul_int8_cuda(x, w, sw, f32),
            lambda: mm.matmul_int8_plain(x, w, sw, f32), 2.0 ** -16)
    del w, sw
    w4 = _int4_weight(torch, gen, K, N)
    for M in (8, 256):
        x = torch.randn((M, K), generator=gen, device="cuda", dtype=f32)
        xq, sx = mm.quantize_activations(x)
        a = (x, w4.packed, w4.scales, 128, f32)
        run(f"K6 fp32 x, fp32 out M={M} K={K} N={N}", lambda: mm.matmul_int4_cuda(*a),
            lambda: mm.matmul_int4_plain(*a), 2.0 ** -16)
        a = (xq, sx, w4.packed, w4.scales, 128, f32)
        run(f"K5 fp32 out M={M} K={K} N={N}", lambda: mm.matmul_w4a8_cuda(*a),
            lambda: mm.matmul_w4a8_plain(*a), 2.0 ** -16)
    del w4


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


def _dequant(k, ks):
    """A bf16 dequantized copy of a cache (scales on all but the last dim)."""
    return (k.float() if ks is None else k.float() * ks[..., None]).bfloat16()


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
                                     return_lse=True, kv_layout="bhsd")
        po, pl = dec.flash_decode_plain(*args)
        ref, rlse = dec.lse_merge(po, pl, axis=0)
        torch.cuda.synchronize()
        err, share = row_err(got, ref.to(torch.bfloat16))
        # fp32 sums of at most 4096 terms in another order: far below 1e-3,
        # while a lost or doubled 64-key tile moves a row's LSE by > 1e-2
        lerr = float((glse - rlse).abs().max())
        ok = checks.check(f"K1 {kv} out", share, 1.0) & checks.check(f"K1 {kv} lse", lerr, 1e-3)
        worst = max(worst, err)
        ms = cuda_ms(torch, lambda: dec.flash_decode_cuda(*args))
        call_ms = cuda_ms(torch, lambda: dec.flash_decode(q, k, v, k_scale=ks, v_scale=vs,
                                                          kv_length=lens, kv_layout="bhsd"))
        plain_ms = cuda_ms(torch, lambda: dec.flash_decode_plain(*args), iters=3)
        kd, vd = _dequant(k, ks), _dequant(v, vs)
        mask = (torch.arange(S, device="cuda")[None, :] < lens[:, None].long())[:, None, None, :]
        lib_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            q[:, :, None, :], kd, vd, attn_mask=mask, enable_gqa=True))
        live = int(lens.long().clamp(max=S).sum())
        nbytes = k1_bytes(k, lens, ks) + 2 * q.numel() * 2 + lens.numel() * 4
        b_ms, b_by = bound(nbytes, 4 * H * D * live)
        say(f"  K1 {kv} ({mode}, {nsplit} splits): max_abs_err {err:.3e} ({share:.3f} of "
            f"its row's tol), lse err {lerr:.3e} (tol 1e-3) "
            f"{'ok' if ok else 'FAIL'} | {ms:.4f} ms ({call_ms:.4f} with the K1m merge), "
            f"plain {plain_ms:.4f}, library (SDPA on the dequantized cache) {lib_ms:.4f}, bound {b_ms:.4f} ({b_by})")
        if kv == "fp8":
            rows["K1"] = dict(name="decode_bhsd (B=8, H=32, Hk=8, S=4096, fp8 KV)",
                              source="flash_attn_tpu_torch/csrc/decode.cu",
                              replaces="flash_attn_tpu/ops/decode.py:747",
                              ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                              bound_ms=b_ms, bound_by=b_by)
        del q, k, v, ks, vs, kd, vd
    rows["K1"]["max_abs_err"] = worst


def check_k1m(torch, checks, rows):
    """K1m, the split-KV combine, on K1's fp8 partials at the decode
    step's shape (B=8, H=32, Hk=8, S=4096, the splits flash_decode picks),
    with lengths S, 1 (every split but the first at -1e30), 0 (an idle
    slot: all at -1e30) and random, and a quarter of the rows' second
    partial set to -inf (JAX's masked value): against lse_merge, each row
    to two bf16 ulps of its largest value (bf16 out) or 2^-16 (fp32 out:
    the same exp and sums in another order), the LSE to 1e-3; the idle
    slot's rows must be out 0 and lse <= -1e29."""
    from flash_attn_tpu_torch.ops import decode as dec
    from flash_attn_tpu_torch.ops.lse import lse_merge, lse_merge_cuda

    g = torch.Generator(device="cuda").manual_seed(SEED + 20)
    q, k, v, ks, vs, lens = _decode_inputs(torch, "fp8", g)
    lens[2] = 0
    B, H, D = q.shape
    S = k.shape[2]
    clamped, clamp2 = _mode_args(dec, k.dtype)
    nsplit, split_len = dec._splits(B, k.shape[1], S, None)
    outs, lses = dec.flash_decode_cuda(q, k, v, ks, vs, lens, D ** -0.5, clamped, clamp2,
                                       nsplit, split_len)
    lses[1, :, ::4] = float("-inf")
    worst = 0.0
    ok = True
    for dtype, rel in ((torch.bfloat16, 2.0 ** -6), (torch.float32, 2.0 ** -16)):
        got, glse = lse_merge_cuda(outs, lses, dtype)
        ref, rlse = lse_merge(outs, lses, axis=0)
        torch.cuda.synchronize()
        err, share = row_err(got, ref.to(dtype), rel=rel)
        lerr = float((glse - rlse).abs().max())
        idle = bool((got[2] == 0).all() and (glse[2] <= -1e29).all())
        name = f"K1m {str(dtype)[6:]} out"
        ok &= checks.check(name, share, 1.0) & checks.check(f"{name} lse", lerr, 1e-3)
        if not idle:
            checks.failed.append(f"{name}: the idle slot is not out 0, lse <= -1e29")
        ok &= idle
        worst = max(worst, err)
        say(f"  K1m {nsplit} splits -> {str(dtype)[6:]}: max_abs_err {err:.3e} ({share:.3f} of "
            f"its row's tol), lse err {lerr:.3e} (tol 1e-3), idle slot {'ok' if idle else 'FAIL'}")
    ms = graph_ms(torch, lambda: lse_merge_cuda(outs, lses, torch.bfloat16))
    loop_ms = cuda_ms(torch, lambda: lse_merge_cuda(outs, lses, torch.bfloat16), iters=100)
    plain_ms = cuda_ms(torch, lambda: lse_merge(outs, lses, axis=0)[0].to(torch.bfloat16))
    nbytes = outs.numel() * 4 + lses.numel() * 4 + outs[0].numel() * 2 + lses[0].numel() * 4
    b_ms, b_by = bound(nbytes, 2 * outs.numel())
    say(f"  K1m {'ok' if ok else 'FAIL'} | {ms:.4f} ms (CUDA graph; {loop_ms:.4f} called from "
        f"Python, the wrapper's host work), plain (eager lse_merge) {plain_ms:.4f}, library "
        f"none, bound {b_ms:.4f} ({b_by})")
    rows["K1m"] = dict(name=f"lse_merge ({nsplit} splits of B=8, H=32, D=128 fp32 partials "
                            "-> bf16)",
                       source="flash_attn_tpu_torch/csrc/lse_merge.cu",
                       replaces="flash_attn_tpu/ops/lse.py:23",
                       ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
                       bound_by=b_by, max_abs_err=worst)
    del q, k, v, ks, vs, outs, lses


def check_k1_shard(torch, checks, rows):
    """K1 on shard views, the sequence-sharded decode's call: a [8, 8,
    16384, 128] fp8 cache (H=32) over 4 ranks sharing the card, each
    rank's [8, 8, 4096, 128] run of the capacity a view of the buffer,
    lengths S, 1, 0 (an idle slot: every shard empty), 4096 (shards 1-3
    empty), 4097 (one key in shard 1) and random.  K1 on each view must be
    bitwise K1 on a contiguous copy of the same shard (partials and LSEs),
    the K1m merge of every shard's splits the plain merge (JAX's formula)
    by the row rule, and the sharded call the single-device flash_decode
    over the whole cache by the row rule; timed beside the plain version
    and SDPA on the gathered dequantized cache."""
    import torch.nn.functional as F

    from flash_attn_tpu_torch.ops import decode as dec
    from flash_attn_tpu_torch.parallel import mesh as pm
    from flash_attn_tpu_torch.parallel import sharded_decode as sd

    g = torch.Generator(device="cuda").manual_seed(SEED + 40)
    B, H, Hk, S, D = 8, 32, 8, 16384, 128
    q, k, v, ks, vs, lens = _decode_inputs(torch, "fp8", g, B=B, H=H, Hk=Hk, S=S, D=D)
    lens[2], lens[3], lens[4] = 0, S // SP_N, S // SP_N + 1
    mesh = pm.make_mesh(pm.MeshConfig(sp=SP_N), devices=["cuda:0"] * SP_N)
    slens = sd.shard_lengths(lens, SP_N, S // SP_N)
    kv_spec, sc_spec = (None, None, "sp", None), (None, None, "sp")
    kr, vr = pm.shard_views(mesh, k, kv_spec), pm.shard_views(mesh, v, kv_spec)
    ksr, vsr = pm.shard_views(mesh, ks, sc_spec), pm.shard_views(mesh, vs, sc_spec)
    views = all(x.data_ptr() == k.data_ptr() + r * (S // SP_N) * D for r, x in enumerate(kr))
    same, outs, lses = True, [], []
    for r in range(SP_N):
        kw = dict(kv_length=slens[r], kv_layout="bhsd")
        o1, l1 = dec.flash_decode_partials(q, kr[r], vr[r], k_scale=ksr[r], v_scale=vsr[r], **kw)
        o2, l2 = dec.flash_decode_partials(q, kr[r].contiguous(), vr[r].contiguous(),
                                           k_scale=ksr[r].contiguous(),
                                           v_scale=vsr[r].contiguous(), **kw)
        same &= bool(torch.equal(o1, o2) and torch.equal(l1, l2))
        outs.append(o1)
        lses.append(l1)
    outs, lses = torch.cat(outs), torch.cat(lses)
    got = sd.merge_shards(outs, lses, torch.bfloat16)
    ref = sd.merge_shards_plain(outs, lses, torch.bfloat16)
    single = dec.flash_decode(q, k, v, k_scale=ks, v_scale=vs, kv_length=lens, kv_layout="bhsd")
    fn = sd.make_sharded_decode(mesh, quantized=True, kv_layout="bhsd")
    call = fn(q, k, v, ks, vs, slens)
    torch.cuda.synchronize()
    err, share = row_err(got, ref)
    serr, sshare = row_err(got, single)
    idle = bool((got[2] == 0).all())
    ok = checks.check("K1 shard merge", share, 1.0) & checks.check("K1 shard vs single", sshare,
                                                                    1.0)
    for name, good in (("views are views of the buffer", views),
                       ("K1 on a view bitwise K1 on a copy", same),
                       ("the idle slot is out 0", idle),
                       ("the call bitwise its parts", bool(torch.equal(call, got)))):
        if not good:
            checks.failed.append(f"K1 shard: {name} fails")
        ok &= good
    ms = graph_ms(torch, lambda: fn(q, k, v, ks, vs, slens))

    def plain():
        parts = [dec.flash_decode_plain(q, kr[r], vr[r], ksr[r], vsr[r], slens[r], D ** -0.5,
                                        True, dec.CLAMP2_DEC_FP8,
                                        *dec._splits(B, Hk, S // SP_N, None))
                 for r in range(SP_N)]
        return sd.merge_shards_plain(torch.cat([p[0] for p in parts]),
                                     torch.cat([p[1] for p in parts]), torch.bfloat16)

    plain_ms = cuda_ms(torch, plain, iters=3, warmup=1)
    kd, vd = _dequant(k, ks), _dequant(v, vs)
    mask = (torch.arange(S, device="cuda")[None, :] < lens[:, None].long())[:, None, None, :]
    lib_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        q[:, :, None, :], kd, vd, attn_mask=mask, enable_gqa=True))
    live = int(lens.long().clamp(max=S).sum())
    nbytes = k1_bytes(k, lens, ks) + 2 * q.numel() * 2 + lens.numel() * 4
    b_ms, b_by = bound(nbytes, 4 * H * D * live)
    nsplit = dec._splits(B, Hk, S // SP_N, None)[0]
    say(f"  K1 shard ({SP_N} views of {S // SP_N} positions, {nsplit} splits each, one K1m "
        f"over {SP_N * nsplit}): views {views}, bitwise a copy's {same}, merge max_abs_err "
        f"{err:.3e} ({share:.3f} of its row's tol), against the single call {serr:.3e} "
        f"({sshare:.3f}), idle slot {'ok' if idle else 'FAIL'} {'ok' if ok else 'FAIL'} | "
        f"{ms:.4f} ms (CUDA graph: 4 K1 + K1m), plain {plain_ms:.4f}, library (SDPA on the "
        f"gathered dequantized cache) {lib_ms:.4f}, bound {b_ms:.4f} ({b_by})")
    rows["K1 shard"] = dict(
        name=f"decode_bhsd on {SP_N} shard views + K1m (B=8, H=32, Hk=8, S={S}, fp8 KV)",
        source="flash_attn_tpu_torch/csrc/decode.cu",
        replaces="flash_attn_tpu/ops/decode.py:747", ms=ms, plain_ms=plain_ms,
        library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by, max_abs_err=max(err, serr))
    del q, k, v, ks, vs, kd, vd, outs, lses


# the 70B projections' slices at tp=4 (K, N): wq, wk / wv, wo, w_gate /
# w_up, w_down; the W8A8 head's column slice
TP4_INT4 = ((8192, 2048), (8192, 256), (2048, 8192), (8192, 7168), (7168, 8192))
TP4_HEAD = (8192, 128256 // 4)


def check_tp_slices(torch, checks, rows):
    """K6 and K7 at Llama-3-70B's tp=4 slices (the shapes phase 23's
    config 4 launches them at): K6 g=128 at M = 8 on every projection's
    slice, K7 bit-exact at M = 8 on the head's column slice, each against
    its plain version, timed beside the library call and the bound."""
    from flash_attn_tpu_torch.ops import matmul as mm
    from flash_attn_tpu_torch.ops.quant import dequantize_int4, quantize_int8

    g = torch.Generator(device="cuda").manual_seed(SEED + 42)
    points, M = {}, 8
    for K, N in TP4_INT4:
        w = _int4_weight(torch, g, K, N)
        wdq = dequantize_int4(w, torch.bfloat16)
        x = torch.randn((M, K), generator=g, device="cuda", dtype=torch.bfloat16)
        args = (x, w.packed, w.scales, 128, torch.bfloat16)
        points[(M, K, N)] = _q_point(
            torch, checks, f"K6 tp4 M={M} K={K} N={N}", lambda: mm.matmul_int4_cuda(*args),
            lambda: mm.matmul_int4_plain(*args), lambda: torch.matmul(x, wdq),
            "matmul on the bf16-dequantized weight",
            M * K * 2 + K * N // 2 + w.scales.numel() * 4 + M * N * 2, 2 * M * K * N)
        del w, wdq
    rows["K6 tp4"] = dict(
        name=f"int4_matmul at 70B's tp=4 slices (M=8, g=128; main K=7168 N=8192, w_down)",
        source="flash_attn_tpu_torch/csrc/matmul_q.cu", replaces="flash_attn_tpu/ops/matmul.py:187",
        max_abs_err=max(p["max_abs_err"] for p in points.values()),
        **{k: points[(M, 7168, 8192)][k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                                   "bound_by")},
        slices={f"{K}x{N}": {k: points[(M, K, N)][k] for k in ("ms", "library_ms", "bound_ms")}
                for K, N in TP4_INT4})
    K, N = TP4_HEAD
    wf = torch.randn((K, N), generator=g, device="cuda", dtype=torch.bfloat16) * 0.02
    w, sw = quantize_int8(wf, dims=(0,))
    w, sw = w.contiguous(), sw[0].contiguous()
    wbf = w.to(torch.bfloat16)
    del wf
    x = torch.randn((M, K), generator=g, device="cuda", dtype=torch.float32)
    xq, sx = mm.quantize_activations(x)
    xb = x.to(torch.bfloat16)
    args = (xq, sx, w, sw, torch.float32)
    pt = _q_point(torch, checks, f"K7 tp4 M={M} K={K} N={N}", lambda: mm.matmul_w8a8_cuda(*args),
                  lambda: mm.matmul_w8a8_plain(*args), lambda: torch.matmul(xb, wbf),
                  "bf16 matmul on the int8 values", M * K + M * 4 + K * N + N * 4 + M * N * 4,
                  2 * M * K * N, INT8_OPS_PER_S, exact=True)
    rows["K7 tp4"] = dict(name=f"w8a8_matmul, 70B head's tp=4 column slice (M=8, K={K}, N={N})",
                          source="flash_attn_tpu_torch/csrc/matmul_q.cu",
                          replaces="flash_attn_tpu/ops/matmul.py:488", **pt)
    del w, wbf


def _chunk_times(torch, kernel, call, lib, nbytes, flops):
    """A chunk point's times: the kernel alone by events and as a replayed
    CUDA graph, the call as a user makes it (reorder, kernel, K1m) as a
    graph, the library call (SDPA) by events, and the bound."""
    b_ms, b_by = bound(nbytes, flops)
    return dict(ms=cuda_ms(torch, kernel), graph_ms=graph_ms(torch, kernel),
                call_graph_ms=graph_ms(torch, call), library_ms=cuda_ms(torch, lib),
                bound_ms=b_ms, bound_by=b_by)


def _say_times(label, t):
    say(f"    {label}: {t['ms']:.4f} ms (graph {t['graph_ms']:.4f}; as called, graph "
        f"{t['call_graph_ms']:.4f}), library (SDPA on the dequantized cache, the chunk's "
        f"causal mask) {t['library_ms']:.4f}, bound {t['bound_ms']:.4f} ({t['bound_by']})")


def check_k1c(torch, checks, rows):
    """K1c, the chunk kernel over a contiguous cache (the verify step's
    attention), at T=5, B=8, Hk=8, S=4096, D=128: H=32 (8B, 20 rows per KV
    head, one warpgroup) with bf16, int8 and fp8 caches and H=64 (70B, 40
    rows) with fp8, lengths random with S, T and an idle slot's S + 7 among
    them; fp8 at the verify step's own lengths (142-923 in the capacity
    4096, as phase 9 calls it) at H=32 and at the draft's H=24 (G=3); and a
    BHSD decode at G=16 (more heads per KV head than K1 holds).  Each in its
    default softmax mode, against the plain version with the same splits,
    each output row to two bf16 ulps of its largest value, and its LSE.  The
    fp8 H=32 points carry their times at both length sets."""
    import torch.nn.functional as F

    from flash_attn_tpu_torch.ops import decode as dec

    g = torch.Generator(device="cuda").manual_seed(SEED + 15)
    B, Hk, S, D = 8, 8, 4096, 128
    worst = 0.0
    times = {}
    for H, kv, T, lens_kind in ((32, "bf16", 5, "random"), (32, "int8", 5, "random"),
                                (32, "fp8", 5, "random"), (64, "fp8", 5, "random"),
                                (32, "fp8", 5, "verify"), (24, "fp8", 5, "verify"),
                                (128, "fp8", 1, "random")):
        _, k, v, ks, vs, _ = _decode_inputs(torch, kv, g, H=H)
        q = torch.randn((B, T, H, D), generator=g, device="cuda", dtype=torch.bfloat16)
        if lens_kind == "verify":
            lens = torch.randint(142, 924, (B,), generator=g, device="cuda", dtype=torch.int32)
        else:
            lens = torch.randint(T, S + 1, (B,), generator=g, device="cuda", dtype=torch.int32)
            lens[0], lens[1], lens[2] = S, T, S + 7
        G = H // Hk
        clamped, clamp2 = _mode_args(dec, k.dtype)
        q2 = q.reshape(B, T, Hk, G, D).transpose(1, 2).reshape(B, Hk * T * G, D).contiguous()
        nsplit = dec._chunk_splits(B, Hk, T * G, S, None)
        args = (q2, k, v, ks, vs, lens, D ** -0.5, clamped, clamp2, nsplit, None, T)
        if T > 1:
            got, glse = dec.flash_decode_chunk(q, k, v, k_scale=ks, v_scale=vs, kv_length=lens,
                                               return_lse=True)
        else:
            got, glse = dec.flash_decode(q[:, 0], k, v, k_scale=ks, v_scale=vs, kv_length=lens,
                                         return_lse=True, kv_layout="bhsd")
        ref2, rlse2 = plain_merge(*dec.flash_decode_plain(*args), torch.bfloat16)
        torch.cuda.synchronize()
        ref = ref2.reshape(B, Hk, T, G, D).transpose(1, 2).reshape(got.shape)
        rlse = rlse2.reshape(B, Hk, T, G).transpose(1, 2).reshape(glse.shape)
        err, share = row_err(got, ref)
        # fp32 sums of at most 4096 terms in another order, as for K1
        lerr = float((glse - rlse).abs().max())
        what = f"T={T}" if T > 1 else "decode"
        label = (f"K1c {kv} H={H} {what}, {lens_kind} lengths ({'clamped' if clamped else 'online'}, "
                 f"{nsplit} splits)")
        ok = checks.check(f"{label} out", share, 1.0) & checks.check(f"{label} lse", lerr, 1e-3)
        worst = max(worst, err)
        ms = cuda_ms(torch, lambda: dec.flash_decode_cuda(*args))
        say(f"  {label}: max_abs_err {err:.3e} ({share:.3f} of its row's tol), lse err "
            f"{lerr:.3e} (tol 1e-3) {'ok' if ok else 'FAIL'} | {ms:.4f} ms")
        if (H, kv) == (32, "fp8"):
            kd, vd = _dequant(k, ks), _dequant(v, vs)
            limit = torch.clamp(lens.long()[:, None] - (T - 1)
                                + torch.arange(T, device="cuda")[None], max=S)  # [B, T]
            mask = (torch.arange(S, device="cuda")[None, None, :] < limit[:, :, None])[:, None]
            qt = q.transpose(1, 2)
            nbytes = k1_bytes(k, lens, ks) + 2 * q.numel() * 2 + lens.numel() * 4
            times[lens_kind] = _chunk_times(
                torch, lambda: dec.flash_decode_cuda(*args),
                lambda: dec.flash_decode_chunk(q, k, v, k_scale=ks, v_scale=vs, kv_length=lens),
                lambda: F.scaled_dot_product_attention(qt, kd, vd, attn_mask=mask,
                                                       enable_gqa=True),
                nbytes, 4 * H * D * int(limit.sum()))
            _say_times(f"K1c fp8 H=32, {lens_kind} lengths", times[lens_kind])
            if lens_kind == "random":
                plain_ms = cuda_ms(torch, lambda: dec.flash_decode_plain(*args), iters=3)
                say(f"    plain {plain_ms:.4f}")
            del kd, vd
        del q, k, v, ks, vs
    rows["K1c"] = dict(name="decode_bhsd, chunk mode (B=8, T=5, H=32, Hk=8, S=4096, fp8 KV)",
                       source="flash_attn_tpu_torch/csrc/chunk_attn.cu",
                       replaces="flash_attn_tpu/ops/decode.py:747",
                       plain_ms=plain_ms, max_abs_err=worst, **times["random"],
                       also=dict(label="the verify step's lengths, 142-923", **times["verify"]))


def check_k1b(torch, checks, rows):
    """K1 over a BSHD cache (B12: JAX's default layout, online softmax, the
    softmax scale on the scores), called through
    flash_attn_tpu_torch.flash_decode with no kv_layout, at B=8, H=32,
    Hk=8, S=4096, D=128 with bf16, int8 and fp8 caches and [B, S, Hk, 1]
    scales; against the plain version as K1 is held."""
    import torch.nn.functional as F

    import flash_attn_tpu_torch as fat
    from flash_attn_tpu_torch.ops import decode as dec
    from flash_attn_tpu_torch.ops.quant import quantize_kv

    g = torch.Generator(device="cuda").manual_seed(SEED + 16)
    B, H, Hk, S, D = 8, 32, 8, 4096, 128
    worst = 0.0
    for kv in ("bf16", "int8", "fp8"):
        q = torch.randn((B, H, D), generator=g, device="cuda", dtype=torch.bfloat16)
        k = torch.randn((B, S, Hk, D), generator=g, device="cuda", dtype=torch.bfloat16)
        v = torch.randn((B, S, Hk, D), generator=g, device="cuda", dtype=torch.bfloat16)
        lens = torch.randint(1, S + 1, (B,), generator=g, device="cuda", dtype=torch.int32)
        lens[0], lens[1] = S, 1
        ks4 = vs4 = ks = vs = None
        if kv != "bf16":
            k, ks4, v, vs4 = quantize_kv(k, v, kv)  # scales [B, S, Hk, 1]
            ks, vs = ks4[..., 0].contiguous(), vs4[..., 0].contiguous()
        nsplit, split_len = dec._splits(B, Hk, S, None)
        args = (q, k, v, ks, vs, lens, D ** -0.5, False, dec._clamp2(k.dtype), nsplit,
                split_len, 1, "bshd")
        got, glse = fat.flash_decode(q, k, v, k_scale=ks4, v_scale=vs4, kv_length=lens,
                                     return_lse=True)
        ref, rlse = plain_merge(*dec.flash_decode_plain(*args), torch.bfloat16)
        torch.cuda.synchronize()
        err, share = row_err(got, ref)
        lerr = float((glse - rlse).abs().max())
        ok = checks.check(f"K1b {kv} out", share, 1.0) & checks.check(f"K1b {kv} lse", lerr, 1e-3)
        worst = max(worst, err)
        ms = cuda_ms(torch, lambda: dec.flash_decode_cuda(*args))
        say(f"  K1b {kv} (BSHD, online, {nsplit} splits): max_abs_err {err:.3e} ({share:.3f} of "
            f"its row's tol), lse err {lerr:.3e} (tol 1e-3) {'ok' if ok else 'FAIL'} | {ms:.4f} ms")
        if kv == "fp8":
            call_ms = cuda_ms(torch, lambda: fat.flash_decode(q, k, v, k_scale=ks4, v_scale=vs4,
                                                              kv_length=lens))
            plain_ms = cuda_ms(torch, lambda: dec.flash_decode_plain(*args), iters=3)
            kd = _dequant(k, ks).transpose(1, 2).contiguous()
            vd = _dequant(v, vs).transpose(1, 2).contiguous()
            mask = (torch.arange(S, device="cuda")[None, :] < lens[:, None].long())[:, None, None, :]
            lib_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                q[:, :, None, :], kd, vd, attn_mask=mask, enable_gqa=True))
            live = int(lens.long().clamp(max=S).sum())
            nbytes = 2 * Hk * live * (D + 4) + 2 * q.numel() * 2 + lens.numel() * 4
            b_ms, b_by = bound(nbytes, 4 * H * D * live)
            say(f"    K1b fp8: {ms:.4f} ms ({call_ms:.4f} with the scale copies and K1m merge), "
                f"plain {plain_ms:.4f}, library (SDPA on the transposed, dequantized cache) "
                f"{lib_ms:.4f}, bound {b_ms:.4f} ({b_by})")
            rows["K1b"] = dict(name="decode over a BSHD cache (B=8, H=32, Hk=8, S=4096, fp8 KV)",
                               source="flash_attn_tpu_torch/csrc/decode.cu",
                               replaces="flash_attn_tpu/ops/decode.py:548",
                               ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                               bound_ms=b_ms, bound_by=b_by)
            del kd, vd
        del q, k, v, ks, vs, ks4, vs4
    rows["K1b"]["max_abs_err"] = worst


def check_g3(torch, checks):
    """The draft model's head grouping (Llama-3.2-3B: H=24, Hk=8, G=3),
    once each: K1 in decode mode over a bf16 cache (the draft's cache) at
    B=8, S=4096, and K4 at B=1, S=2048 (causal, rope, clamped)."""
    from flash_attn_tpu_torch.ops import decode as dec
    from flash_attn_tpu_torch.ops import flash_fwd as ff
    from flash_attn_tpu_torch.ops.rope import rope_cos_sin

    g = torch.Generator(device="cuda").manual_seed(SEED + 17)
    q, k, v, _, _, lens = _decode_inputs(torch, "bf16", g, H=24)
    D = q.shape[-1]
    nsplit, split_len = dec._splits(8, 8, 4096, None)
    args = (q, k, v, None, None, lens, D ** -0.5, False, dec.CLAMP2_DEC, nsplit, split_len)
    got, glse = dec.flash_decode(q, k, v, kv_length=lens, return_lse=True, kv_layout="bhsd")
    ref, rlse = plain_merge(*dec.flash_decode_plain(*args), torch.bfloat16)
    torch.cuda.synchronize()
    err, share = row_err(got, ref)
    lerr = float((glse - rlse).abs().max())
    ok = checks.check("K1 H=24 out", share, 1.0) & checks.check("K1 H=24 lse", lerr, 1e-3)
    ms = cuda_ms(torch, lambda: dec.flash_decode_cuda(*args))
    say(f"  K1 bf16 H=24 Hk=8: max_abs_err {err:.3e} ({share:.3f} of its row's tol), lse err "
        f"{lerr:.3e} {'ok' if ok else 'FAIL'} | {ms:.4f} ms")
    del q, k, v
    B, S, H, Hk = 1, 2048, 24, 8
    q = torch.randn((B, S, H, D), generator=g, device="cuda", dtype=torch.bfloat16)
    k = torch.randn((B, S, Hk, D), generator=g, device="cuda", dtype=torch.bfloat16)
    v = torch.randn((B, S, Hk, D), generator=g, device="cuda", dtype=torch.bfloat16)
    cos, sin = rope_cos_sin(torch.arange(S, device="cuda")[None], D, 500000.0)
    out, lse = ff.flash_fwd(q, k, v, causal=True, rope_cos=cos, rope_sin=sin, softmax_mode="clamped")
    rout, rlse = ff.flash_fwd_plain(q, k, v, True, D ** -0.5, cos, sin, True)
    torch.cuda.synchronize()
    err, share = row_err(out, rout)
    lerr = float((lse - rlse).abs().max())
    ok = checks.check("K4 H=24 out", share, 1.0) & checks.check("K4 H=24 lse", lerr, 1e-3)
    ms = cuda_ms(torch, lambda: ff.flash_fwd_cuda(q, k, v, True, D ** -0.5, cos, sin, True))
    say(f"  K4 clamped H=24 Hk=8 B=1 S=2048: max_abs_err {err:.3e} ({share:.3f} of its row's "
        f"tol), lse err {lerr:.3e} {'ok' if ok else 'FAIL'} | {ms:.4f} ms")


# (mode, Hk, S, D, the row its times fill): K2 at B=8 at each decode step's
# shape; GPT-2's row is int8, BASELINE config 0's KV type
K2_POINTS = (("int8", 8, 4096, 128, None), ("fp8", 8, 4096, 128, "K2"),
             ("int8", 8, 8192, 256, None), ("fp8", 8, 8192, 256, "K2 d256"),
             ("int8", 12, 1024, 64, "K2 d64"), ("fp8", 12, 1024, 64, None),
             ("int8", 4, 4096, 128, None), ("fp8", 4, 4096, 128, "K2 G7"))


def check_k2(torch, checks, rows):
    """K2 in int8 and fp8 at B=8 at K2_POINTS (Llama-3's, Gemma-2-9B's,
    GPT-2 124M's and Qwen-2-7B's decode step), bit for bit against its
    plain version (an idle slot past the capacity writes nothing); the
    points named there carry their times (the "K2", "K2 d256", "K2 d64" and
    "K2 G7" rows): a loop of
    wrapper calls by events, the
    kernel as a replayed CUDA graph, and beside it the graph time of an
    empty kernel on K2's grid, launched the same way (the floor of a kernel
    this small)."""
    from flash_attn_tpu_torch import _build
    from flash_attn_tpu_torch.ops import kv_append as ka

    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    B = 8
    worst = 0.0
    for mode, Hk, S, D, row in K2_POINTS:
        if mode == "int8":
            kc = torch.randint(-127, 128, (B, Hk, S, D), generator=g, device="cuda",
                               dtype=torch.int8)
        else:
            kc = torch.randn((B, Hk, S, D), generator=g, device="cuda").to(torch.float8_e4m3fn)
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
        ok = checks.check(f"K2 {mode} D={D}", err, 0.0)
        worst = max(worst, err)
        def k2():
            ka.kv_append_cuda(kc, vc, ks, vs, nk, nv, lens, mode)

        def empty():
            _build.check(_build.lib().fatt_empty(B, Hk, _build.stream()), "fatt_empty")

        ms = cuda_ms(torch, k2, iters=100)
        g_ms, empty_ms = graph_ms(torch, k2), graph_ms(torch, empty)
        plain_ms = cuda_ms(torch, lambda: ka.kv_append_plain(kc, vc, ks, vs, nk, nv, lens, mode))
        nbytes = 2 * B * Hk * D * 2 + 2 * B * Hk * D * 1 + 2 * B * Hk * 4 + B * 4
        b_ms, b_by = bound(nbytes, 0)
        say(f"  K2 {mode} Hk={Hk} S={S} D={D}: max_abs_err {err:.3e} (tol 0) "
            f"{'ok' if ok else 'FAIL'} | {ms:.4f} ms (a loop of wrapper calls; graph {g_ms:.4f}, an empty kernel on its "
            f"grid {empty_ms:.4f}), plain {plain_ms:.4f}, library none, bound {b_ms:.6f} "
            f"({b_by})")
        if row:
            rows[row] = dict(
                name=f"kv_append (B=8, Hk={Hk}, S={S}, D={D}, {mode})",
                source="flash_attn_tpu_torch/csrc/kv_append.cu",
                replaces="flash_attn_tpu/ops/kv_append.py:57",
                ms=ms, graph_ms=g_ms, empty_graph_ms=empty_ms,
                plain_ms=plain_ms, library_ms=None,
                bound_ms=b_ms, bound_by=b_by, max_abs_err=err)
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


K4_SHAPES = (  # (B, Sq, Sk, H, Hk, per-sequence rope): the prefill's and training's
    (1, 891, 891, 32, 8, False),     # a phase-4 prompt length (ragged tiles)
    (1, 1000, 1500, 32, 8, False),   # a shifted causal mask (a suffix over a prefix)
    (2, 1024, 1024, 32, 8, True),    # two sequences, each its own rope positions
    (1, 2048, 2048, 24, 8, False),   # the 3B-width draft's G=3
)


def check_k4_shapes(torch, checks):
    """K4 in both softmax modes at K4_SHAPES (causal, rope), against its
    plain version as check_k4 holds it."""
    from flash_attn_tpu_torch.ops import flash_fwd as ff
    from flash_attn_tpu_torch.ops.rope import rope_cos_sin

    g = torch.Generator(device="cuda").manual_seed(SEED + 21)
    D = 128
    for B, Sq, Sk, H, Hk, per_seq in K4_SHAPES:
        q = torch.randn((B, Sq, H, D), generator=g, device="cuda", dtype=torch.bfloat16)
        k = torch.randn((B, Sk, Hk, D), generator=g, device="cuda", dtype=torch.bfloat16)
        v = torch.randn((B, Sk, Hk, D), generator=g, device="cuda", dtype=torch.bfloat16)
        pos = torch.arange(Sq, device="cuda")[None] + (Sk - Sq)
        if per_seq:
            pos = pos + 37 * torch.arange(B, device="cuda")[:, None]
        cos, sin = rope_cos_sin(pos, D, 500000.0)
        for mode in ("clamped", "online"):
            clamped = mode == "clamped"
            out, lse = ff.flash_fwd(q, k, v, causal=True, rope_cos=cos, rope_sin=sin,
                                    softmax_mode=mode)
            rout, rlse = ff.flash_fwd_plain(q, k, v, True, D ** -0.5, cos, sin, clamped)
            torch.cuda.synchronize()
            err, share = row_err(out, rout)
            lerr = float((lse - rlse).abs().max())
            label = f"K4 {mode} B={B} Sq={Sq} Sk={Sk} H={H} Hk={Hk}"
            ok = checks.check(f"{label} out", share, 1.0) & checks.check(f"{label} lse", lerr, 1e-3)
            ms = cuda_ms(torch, lambda: ff.flash_fwd_cuda(q, k, v, True, D ** -0.5, cos, sin,
                                                          clamped))
            flops = k4_flops(B, Sq, Sk, H, D)
            say(f"  {label}{' per-sequence rope' if per_seq else ''}: max_abs_err {err:.3e} "
                f"({share:.3f} of its row's tol), lse err {lerr:.3e} (tol 1e-3) "
                f"{'ok' if ok else 'FAIL'} | {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s)")
        del q, k, v


def _packed_positions(torch, lens, S):
    """Segment ids (1, 2, ... a prompt; 0 padding) and positions
    (restarting at 0 a prompt; 0 padding) of prompts of ``lens`` packed in
    order into one [1, S] row, as the engine packs them (CPU tensors)."""
    seg = torch.zeros((1, S), dtype=torch.int32)
    pos = torch.zeros((1, S), dtype=torch.int32)
    off = 0
    for i, n in enumerate(lens):
        seg[0, off:off + n] = i + 1
        pos[0, off:off + n] = torch.arange(n)
        off += n
    return seg, pos


def tile_test(q_ranges, k_ranges, causal: bool, Sq: int, Sk: int, window=None):
    """The test K4 runs when it lists a block's key tiles, in plain
    PyTorch, on ``ops/flash_fwd.py:tile_meta``'s ranges: (live, full), each
    [B, nq, nk] bool.  A (q tile, k tile) pair is skipped unless its ranges
    of segment ids overlap, the k tile's least position is at most the q
    tile's greatest, (with ``causal``) the tile starts at or before the
    q tile's last row's diagonal and (with a ``window`` (left, right) on
    the positions) the k tile's greatest position is >= the q tile's least
    - left and its least <= the q tile's greatest + right; ``full`` marks a
    listed pair that needs no segment or position mask (one segment on
    both sides, greatest kv position <= least q position, and within the
    window: least kv position >= greatest q position - left, greatest <=
    least + right).  The reference that the kernel's own counts
    (``k4_tile_counts``) are held to."""
    import torch

    tile = 64
    nq, nk = q_ranges.shape[1], k_ranges.shape[1]
    qr, kr = q_ranges[:, :, None], k_ranges[:, None]
    live = (kr[..., 2] >= qr[..., 0]) & (kr[..., 0] <= qr[..., 2]) & (kr[..., 1] <= qr[..., 3])
    if causal:
        row_last = torch.clamp(torch.arange(nq) * tile + tile - 1, max=Sq - 1) + (Sk - Sq)
        kv_end = torch.clamp(row_last + 1, max=Sk)
        live = live & (torch.arange(nk)[None, :] * tile < kv_end[:, None]).to(live.device)
    one = (qr[..., 0] == qr[..., 2]) & (kr[..., 0] == kr[..., 2]) & (kr[..., 0] == qr[..., 0])
    full = one & (kr[..., 3] <= qr[..., 1])
    left, right = window or (-1, -1)
    if left >= 0:
        live = live & (kr[..., 3] >= qr[..., 1] - left)
        full = full & (kr[..., 1] >= qr[..., 3] - left)
    if right >= 0:
        live = live & (kr[..., 1] <= qr[..., 3] + right)
        full = full & (kr[..., 3] <= qr[..., 1] + right)
    return live, live & full


def k4_tile_counts(torch, checks, label, q, k, v, cos, sin, causal, masks, window=None,
                   softcap=None):
    """One launch of K4's C entry with its tile count on (not through the
    wrapper, so not a launch of the main path): the key tiles that head
    0's blocks listed and of those the ones walked unmasked, summed over
    the batch, as the kernel counted them (with a window or a softcap the
    masked kLocal instance, its window on the positions).  Fails the check
    unless they equal ``tile_test``'s counts on the same ranges.  Returns
    (live, unmasked, all tile pairs)."""
    from flash_attn_tpu_torch import _build
    from flash_attn_tpu_torch.ops import flash_fwd as ff

    B, Sq, H, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    qmeta, qr = ff.tile_meta(masks.q_segment_ids, masks.q_positions, B, Sq)
    kmeta, kr = ff.tile_meta(masks.kv_segment_ids, masks.kv_positions, B, Sk)
    counts = torch.zeros(2, dtype=torch.int32, device="cuda")
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device="cuda")
    p = _build.ptr
    _build.check(_build.lib().fatt_flash_fwd(
        p(q), p(k), p(v), p(cos), p(sin), p(out), p(lse), p(qmeta), p(kmeta), p(qr), p(kr),
        p(counts), B, Sq, Sk, H, Hk, D, 0, float(D ** -0.5 * ff.LOG2E), int(causal), 1,
        *ff.local_args(window, softcap), *ff.extra_args(None, None), *ff.surface_args(),
        ff.window_idx(window, masks), _build.stream()), "fatt_flash_fwd")
    live, full = tile_test(qr, kr, causal, Sq, Sk, window)
    got, want = counts.tolist(), [int(live.sum()), int(full.sum())]
    if got != want:
        checks.failed.append(f"{label}: K4 listed (live, unmasked) tiles {got}, the tile "
                             f"test {want}")
    return got[0], got[1], int(live.numel())


def check_k4_masked(torch, checks, rows):
    """K4 with masks, no causal flag, both softmax modes, against its plain
    version as check_k4 holds it (a skipped live tile fails the row and
    LSE checks): segment ids and positions at the packed prefill's shape
    (phase 4's eight prompts in the 4096 bucket, 646 padding tokens, B=1
    H=32 Hk=8), and positions alone at a chunk's (Sq=512 at start 1024 over
    a 4096-position cache).  For each (clamped): the kernel's time alone
    (its tile metadata made once; events and a CUDA graph) and as called
    (the wrapper's tile metadata held from the call before, and made anew
    each call), the plain version's, the library's
    (SDPA on rotated q with the boolean mask, enable_gqa) and the bound on
    the pairs the masks leave live; and the key tiles K4 listed and walked
    unmasked, as it counted them, held equal to ``tile_test``'s.  Adds them
    to K4's row."""
    import torch.nn.functional as F

    from flash_attn_tpu_torch import _build
    from flash_attn_tpu_torch.ops import flash_fwd as ff
    from flash_attn_tpu_torch.ops.rope import rope_cos_sin, rope_rotate

    g = torch.Generator(device="cuda").manual_seed(SEED + 22)
    H, Hk, D = 32, 8, 128
    lens, _ = _prompts(128256)
    seg, pos = (x.cuda() for x in _packed_positions(torch, [int(n) for n in lens], 4096))
    cpos = torch.arange(1024, 1536, device="cuda", dtype=torch.int32)[None]
    kpos = torch.arange(4096, device="cuda", dtype=torch.int32)[None]
    cases = {"packed": (4096, 4096, ff.Masks(seg, seg, pos, pos), pos),
             "chunk": (512, 4096, ff.Masks(None, None, cpos, kpos), cpos)}
    worst = rows["K4"]["max_abs_err"]
    for name, (Sq, Sk, masks, qpos) in cases.items():
        q = torch.randn((1, Sq, H, D), generator=g, device="cuda", dtype=torch.bfloat16)
        k = torch.randn((1, Sk, Hk, D), generator=g, device="cuda", dtype=torch.bfloat16)
        v = torch.randn((1, Sk, Hk, D), generator=g, device="cuda", dtype=torch.bfloat16)
        cos, sin = rope_cos_sin(qpos, D, 500000.0)
        live = ff.live_pairs(masks, False, Sq, Sk, "cuda")
        n_live = int(live.sum())
        qmeta, qr = ff.tile_meta(masks.q_segment_ids, masks.q_positions, 1, Sq)
        kmeta, kr = ff.tile_meta(masks.kv_segment_ids, masks.kv_positions, 1, Sk)
        label = f"K4 {name} Sq={Sq} Sk={Sk} H={H} Hk={Hk}"
        n_tiles, n_full, n_all = k4_tile_counts(torch, checks, label, q, k, v, cos, sin,
                                                False, masks)
        for mode in ("clamped", "online"):
            clamped = mode == "clamped"
            out, lse = ff.flash_fwd(q, k, v, rope_cos=cos, rope_sin=sin, softmax_mode=mode,
                                    **masks._asdict())
            rout, rlse = ff.flash_fwd_plain(q, k, v, False, D ** -0.5, cos, sin, clamped, masks)
            torch.cuda.synchronize()
            err, share = row_err(out, rout)
            lerr = float((lse - rlse).abs().max())
            ok = (checks.check(f"{label} {mode} out", share, 1.0)
                  & checks.check(f"{label} {mode} lse", lerr, 1e-3))
            worst = max(worst, err)
            line = (f"  {label} {mode}: max_abs_err {err:.3e} ({share:.3f} of its row's tol), "
                    f"lse err {lerr:.3e} (tol 1e-3) {'ok' if ok else 'FAIL'}")
            if not clamped:
                say(line)
                continue
            o2, l2 = torch.empty_like(q), torch.empty_like(lse)
            p, lib = _build.ptr, _build.lib()

            def kernel():
                _build.check(lib.fatt_flash_fwd(
                    p(q), p(k), p(v), p(cos), p(sin), p(o2), p(l2), p(qmeta), p(kmeta), p(qr),
                    p(kr), None, 1, Sq, Sk, H, Hk, D, 0, float(D ** -0.5 * ff.LOG2E), 0, 1,
                    -1, -1, 0.0, *ff.extra_args(None, None), *ff.surface_args(), 0,
                    _build.stream()), "fatt_flash_fwd")

            kernel()
            torch.cuda.synchronize()
            if not (torch.equal(o2, out) and torch.equal(l2, lse)):
                checks.failed.append(f"{label}: the kernel alone differs from the wrapper's call")
            res = dict(Sq=Sq, Sk=Sk, live_pairs=n_live, live_tiles=n_tiles,
                       unmasked_tiles=n_full, ms=cuda_ms(torch, kernel),
                       graph_ms=graph_ms(torch, kernel),
                       call_ms=cuda_ms(torch, lambda: ff.flash_fwd_cuda(
                           q, k, v, False, D ** -0.5, cos, sin, True, masks)),
                       first_call_ms=cuda_ms(torch, lambda: (
                           setattr(ff._tiles, "last", None),
                           ff.flash_fwd_cuda(q, k, v, False, D ** -0.5, cos, sin, True, masks))),
                       plain_ms=cuda_ms(torch, lambda: ff.flash_fwd_plain(
                           q, k, v, False, D ** -0.5, cos, sin, True, masks), iters=3))
            qr_ = rope_rotate(q, cos, sin).transpose(1, 2).contiguous()
            kt, vt = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
            res["library_ms"] = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                qr_, kt, vt, attn_mask=live[:, None], enable_gqa=True))
            flops = 4 * H * D * n_live
            nbytes = (q.numel() * 2 * 2 + k.numel() * 2 * 2 + cos.numel() * 4 * 2
                      + lse.numel() * 4 + (Sq + Sk) * 8)
            res["bound_ms"], res["bound_by"] = bound(nbytes, flops)
            rows["K4"][name] = res
            say(f"{line} | {res['ms']:.4f} ms alone (graph {res['graph_ms']:.4f}, "
                f"{flops / res['graph_ms'] / 1e9:.1f} TFLOP/s on live pairs), as called "
                f"{res['call_ms']:.4f} (tile metadata held, as in a prefill's later layers; "
                f"made anew, as in its first: {res['first_call_ms']:.4f}), plain {res['plain_ms']:.4f}, library (SDPA, boolean "
                f"mask) {res['library_ms']:.4f}, bound {res['bound_ms']:.4f} ({res['bound_by']}) | "
                f"live pairs {n_live} of {Sq * Sk}, K4 listed {n_tiles} of {n_all} tiles "
                f"({n_full} unmasked; the tile test's counts alike)")
        del q, k, v, live
    rows["K4"]["max_abs_err"] = worst
    check_k4_mask_mix(torch, checks)


def check_k4_mask_mix(torch, checks):
    """K4 against its plain version, both softmax modes, where the masks
    compose and the tile lists are irregular: segments with the causal
    flag at B=2 (varlen-like, ragged 300), random unsorted segment ids with
    positions (tiles of many segments, rows with no live key: out 0, lse
    -1e30) at Sq=77 Sk=200, segments alone at B=2 S=130, positions with a
    shifted causal flag at Sq=100 Sk=250, and blocks with one live tile or
    none (segment ids a tile, one k tile's changed; positions).  Each
    case's tile lists are counted by the kernel and held to
    ``tile_test``'s."""
    from flash_attn_tpu_torch.ops import flash_fwd as ff
    from flash_attn_tpu_torch.ops.rope import rope_cos_sin

    g = torch.Generator(device="cuda").manual_seed(SEED + 23)
    D = 128

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device="cuda", dtype=torch.int32)

    def runs(B, S, n):
        return torch.sort(ints(1, n + 1, (B, S)), dim=1).values

    pos300 = torch.arange(300, device="cuda", dtype=torch.int32)[None].expand(2, 300)
    tile_ids = (pos300[:1, :256] // 64 + 1).contiguous()  # q tile t (k tile t): segment t+1
    cases = (  # (label, B, Sq, Sk, H, Hk, causal, q_seg, kv_seg, q_pos, kv_pos)
        ("segments + causal", 2, 300, 300, 8, 2, True, *(2 * (runs(2, 300, 3),)), None, None),
        ("random segments + positions", 1, 77, 200, 8, 8, False, ints(0, 4, (1, 77)),
         ints(0, 4, (1, 200)), ints(0, 200, (1, 77)), ints(0, 200, (1, 200))),
        ("segments", 2, 130, 130, 4, 1, False, *(2 * (runs(2, 130, 4),)), None, None),
        ("positions + causal", 1, 100, 250, 8, 2, True, None, None,
         torch.arange(150, 250, device="cuda", dtype=torch.int32)[None],
         ints(0, 300, (1, 250))),
        ("one live tile or none a block", 1, 256, 256, 4, 2, False, tile_ids,
         torch.where(tile_ids == 3, 9, tile_ids), pos300[:1, :256], pos300[:1, :256]),
    )
    for label, B, Sq, Sk, H, Hk, causal, qs, ks, qp, kp in cases:
        masks = ff.Masks(qs, ks, qp, kp)
        q = torch.randn((B, Sq, H, D), generator=g, device="cuda", dtype=torch.bfloat16)
        k = torch.randn((B, Sk, Hk, D), generator=g, device="cuda", dtype=torch.bfloat16)
        v = torch.randn((B, Sk, Hk, D), generator=g, device="cuda", dtype=torch.bfloat16)
        cos, sin = rope_cos_sin(torch.arange(Sq, device="cuda")[None], D, 500000.0)
        n_tiles, n_full, n_all = k4_tile_counts(torch, checks, f"K4 {label}", q, k, v, cos,
                                                sin, causal, masks)
        for mode in ("clamped", "online"):
            clamped = mode == "clamped"
            out, lse = ff.flash_fwd(q, k, v, causal=causal, rope_cos=cos, rope_sin=sin,
                                    softmax_mode=mode, **masks._asdict())
            rout, rlse = ff.flash_fwd_plain(q, k, v, causal, D ** -0.5, cos, sin, clamped, masks)
            torch.cuda.synchronize()
            err, share = row_err(out, rout)
            lerr = float((lse - rlse).abs().max())
            name = f"K4 {label} B={B} Sq={Sq} Sk={Sk} {mode}"
            ok = checks.check(f"{name} out", share, 1.0) & checks.check(f"{name} lse", lerr, 1e-3)
            dead = int((rlse <= ff.NEG_INF / 2).sum())
            say(f"  {name}: max_abs_err {err:.3e} ({share:.3f} of its row's tol), lse err "
                f"{lerr:.3e} (tol 1e-3), {dead} rows with no live key, K4 listed {n_tiles} of "
                f"{n_all} tiles ({n_full} unmasked) {'ok' if ok else 'FAIL'}")


def _bwd_inputs(torch, g, B, Sq, Sk, causal, rope, H=32, Hk=8, D=128, window=None,
                softcap=None, scale=None, theta=500000.0, q_mult=1.0):
    """Random bf16 q (times ``q_mult``), k, v, dout; out and lse from K4
    (online, with the window and the softcap given); delta as flash_bwd
    forms it; RoPE tables (each sequence its own positions) or None."""
    from flash_attn_tpu_torch.ops import flash_fwd as ff
    from flash_attn_tpu_torch.ops.rope import rope_cos_sin

    q = torch.randn((B, Sq, H, D), generator=g, device="cuda", dtype=torch.bfloat16) * q_mult
    k = torch.randn((B, Sk, Hk, D), generator=g, device="cuda", dtype=torch.bfloat16)
    v = torch.randn((B, Sk, Hk, D), generator=g, device="cuda", dtype=torch.bfloat16)
    dout = torch.randn((B, Sq, H, D), generator=g, device="cuda", dtype=torch.bfloat16)
    cos = sin = None
    if rope:
        pos = torch.arange(Sq, device="cuda")[None] + 7 * torch.arange(B, device="cuda")[:, None]
        cos, sin = rope_cos_sin(pos, D, theta)
    out, lse = ff.flash_fwd(q, k, v, causal=causal, rope_cos=cos, rope_sin=sin, scale=scale,
                            window=window, logit_softcap=softcap)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    return q, k, v, dout, lse, delta, cos, sin


def one_key_floor(torch, ref, Sk, causal):
    """Per-row floor for dq [B, Sq, H, D]: 2^-12 of its largest |value| on
    the rows of queries that see fewer than two keys under the bottom-right
    causal mask (their true gradient is 0), 1e-6 on every other row."""
    B, Sq, H, _ = ref.shape
    i = torch.arange(Sq, device=ref.device)
    live = torch.clamp(i + Sk - Sq + 1, 0, Sk) if causal else torch.full_like(i, Sk)
    noise = 2.0 ** -12 * float(ref.abs().max())
    return torch.where(live < 2, noise, 1e-6)[None, :, None].expand(B, Sq, H)


def ds_floor(torch, ref, causal):
    """Per-row floor for dS-shaped [b, h, Sq, Sk] (dS, or dbias summed
    from it): 2^-12 of its largest |value| on the rows of queries that see
    fewer than two keys under the bottom-right causal mask (there dP =
    delta up to fp32 summation order, so both sides give rounding noise, as
    one_key_floor's dq rows), 1e-6 on every other row."""
    b, h, Sq, Sk = ref.shape
    i = torch.arange(Sq, device=ref.device)
    live = torch.clamp(i + Sk - Sq + 1, 0, Sk) if causal else torch.full_like(i, Sk)
    noise = 2.0 ** -12 * float(ref.abs().max())
    return torch.where(live < 2, noise, 1e-6)[None, None, :].expand(b, h, Sq)


def sdpa_bwd_device_ms(torch, fn, calls=10):
    """Device time of one call of ``fn`` (a backward of SDPA) and the
    backend that ran it: the sum of the CUDA kernels' times that
    torch.profiler records over ``calls`` calls, divided by ``calls``.
    Autograd runs a backward on the stream of its forward, so the call
    alone does not go into a CUDA graph as the kernels' wrappers do.
    Returns (ms, backend, kernel names); ms is None when the profiler saw
    no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if str(e.device_type).endswith("CUDA")]
    names = sorted({e.name for e in kernels})
    us = sum(e.time_range.elapsed_us() for e in kernels)
    text = " ".join(names).lower()
    backend = ("cudnn" if "cudnn" in text else "flash" if "flash" in text
               else "efficient" if "fmha" in text or "mem_eff" in text else "math")
    return (us / calls / 1e3 if us > 0 else None), backend, names


def _bwd_case(torch, checks, worst, label, args, tail, causal, dq_floor=None, kw=None):
    """K9 and K10 each launched twice, on ``args`` and on K9's R(q) with
    ``tail`` (and the keywords ``kw``: ALiBi slopes for both, ``want_ds``
    for K9), against flash_bwd_plain (through bwd_plain): every output row
    within its tolerance (``row_err``; dq rows of queries that see one key
    with ``one_key_floor``, or ``dq_floor(reference dq)`` where given; with
    ``want_ds`` also dS's rows, with ``ds_floor``), R(q) bitwise
    rope_rotate's, the second
    launch bitwise the first.  Adds each kernel's max |err| into
    ``worst``; returns (dq, rq, dk, dv, {kernel: its result text})."""
    from flash_attn_tpu_torch.ops import flash_bwd as fb
    from flash_attn_tpu_torch.ops.rope import rope_rotate

    kw = kw or {}
    kw10 = {n: x for n, x in kw.items() if n == "alibi"}
    q, k, cos, sin = args[0], args[1], args[8], args[9]
    r9, r9b = fb.flash_bwd_dq_cuda(*args, **kw), fb.flash_bwd_dq_cuda(*args, **kw)
    (dq, rq), (dq2, rq2) = r9[:2], r9b[:2]
    (dk, dv), (dk2, dv2) = (fb.flash_bwd_dkv_cuda(rq, *tail, **kw10),
                            fb.flash_bwd_dkv_cuda(rq, *tail, **kw10))
    ref = bwd_plain(args, **kw)
    rdq, rdk, rdv = ref[:3]
    rq_ok = torch.equal(rq, q if cos is None else rope_rotate(q, cos, sin))
    torch.cuda.synchronize()
    same = {"K9": torch.equal(dq, dq2) and torch.equal(rq, rq2)
            and all(torch.equal(a, b) for a, b in zip(r9[2:], r9b[2:])),
            "K10": torch.equal(dk, dk2) and torch.equal(dv, dv2)}
    if not rq_ok:
        checks.failed.append(f"K9 {label}: R(q) differs from rope_rotate")
    res = {}
    floors = {"dq": one_key_floor(torch, rdq, k.shape[1], causal) if dq_floor is None
              else dq_floor(rdq)}
    if kw.get("want_ds"):
        floors["dS"] = ds_floor(torch, ref[3], causal)
    k9_outs = ((dq, rdq, "dq"),) + (((r9[2], ref[3], "dS"),) if kw.get("want_ds") else ())
    for key, outs in (("K9", k9_outs), ("K10", ((dk, rdk, "dk"), (dv, rdv, "dv")))):
        parts = []
        for got, ref, name in outs:
            err, share = row_err(got, ref, floor=floors.get(name, 1e-6))
            checks.check(f"{key} {name} {label}", share, 1.0)
            worst[key] = max(worst[key], err)
            parts.append(f"{name} max_abs_err {err:.3e} ({share:.3f} of its row's tol)")
        if not same[key]:
            checks.failed.append(f"{key} {label}: two launches differ")
        res[key] = "; ".join(parts) + f", bitwise repeat {'ok' if same[key] else 'FAIL'}"
    res["K9"] += f", R(q) {'bitwise ok' if rq_ok else 'FAIL'}"
    return dq, rq, dk, dv, res


class BwdCase(NamedTuple):
    """One K9/K10 case of check_k9_k10: shape, options (``scale``, default
    D^-0.5; rope theta Llama-3's at D=128 without ``tag``, else 10000),
    ``q_mult`` scales q so that the scores reach the cap, ``tag`` names the
    kernels' rows the case belongs to (default by head dim: K9 and K10 at
    128, K9 d256 and K10 d256 at 256, K9 d64 and K10 d64 at 64; " 27B":
    K9 27B and K10 27B, Gemma-2-27B's head_dim 128 kLocal instances), and
    ``row`` says where this case's times go in them: None nowhere, "" the
    rows themselves, else the name of a sub-dict of them."""
    B: int
    Sq: int
    Sk: int
    H: int
    Hk: int
    D: int
    causal: bool
    rope: bool
    window: tuple | None = None
    cap: float | None = None
    q_mult: float = 1.0
    row: str | None = None
    scale: float | None = None
    tag: str | None = None

    @property
    def softmax_scale(self) -> float:
        return self.D ** -0.5 if self.scale is None else self.scale

    @property
    def suffix(self) -> str:
        """The suffix of the kernels' rows this case belongs to."""
        if self.tag is not None:
            return self.tag
        return "" if self.D == 128 else f" d{self.D}"

    @property
    def bends(self) -> bool:
        """The scores (~N(0, q_mult^2)) reach where tanh(s / cap) is far
        from linear."""
        return self.cap is not None and self.q_mult / self.cap >= 0.1


# K9/K10 cases.  At D=128 (Llama widths): the training shape first (the
# rows K9 and K10), the bottom-right shift with ragged tiles on both sides
# (Sq and Sk not multiples of the kernels' 128-row blocks or 64-row tiles),
# non-causal at B=2 with per-sequence rope, group sizes 1 and 8 (the 70B
# widths), and non-causal at the training shape (every tile live).  At
# Gemma-2-9B's D=256 (causal, rope, softcap 50): the training shape
# windowed and causal (the rows K9 d256 and K10 d256, the causal one as
# their no_window), a ragged shifted case (Sq not a multiple of 64,
# Sq < Sk) with and without a window, and S just past the window.  Scores
# of ~N(0, 1) leave tanh(s / 50) nearly linear (the capped score differs
# from s by ~s^3 / 7500), so a kernel without the cap's 1 - t^2 factor, or
# without the cap, would pass those: the last two cases bend it with cap 5
# (t to ~0.8), windowed and causal.  (Bending it with q x8 at cap 50 makes
# the softmax of the first queries one-hot, whose dq is then fp32 noise on
# both sides, as for a query that sees one key; chip_tools/k9_probe.py
# reports that case.)  At GPT-2's D=64 (H = Hk = 12, no rope in the model):
# the training shape B=8 S=1024 causal (the rows K9 d64 and K10 d64), a
# ragged shifted case with GQA 12/4 and rope (K9's rope pull-back at 64
# pairs a column with the one 32 away, inside the one 64-column part: a
# missed pull-back fails here), and non-causal at B=2 with per-sequence
# rope.  At Gemma-2-27B's D=128 (H=32, Hk=16, scale 1/12, rope, softcap
# 50; the kLocal instances beside Llama's): as at 256, the training shape
# windowed and causal (the rows K9 27B and K10 27B), a ragged shifted
# windowed case and the cap-5 pair, and non-causal with a two-sided window
# (8, 2), Sq < Sk (JAX takes it; no Gemma-2 path does).
BWD_CASES = (
    BwdCase(1, 2048, 2048, 32, 8, 128, True, True, row=""),
    BwdCase(1, 1000, 1500, 32, 8, 128, True, False),
    BwdCase(2, 1000, 1500, 32, 8, 128, False, True),
    BwdCase(1, 2048, 2048, 8, 8, 128, True, True),
    BwdCase(1, 2048, 2048, 64, 8, 128, True, True),
    BwdCase(1, 2048, 2048, 32, 8, 128, False, True),
    BwdCase(1, 8192, 8192, 16, 8, 256, True, True, (4095, -1), 50.0, row=""),
    BwdCase(1, 8192, 8192, 16, 8, 256, True, True, None, 50.0, row="no_window"),
    BwdCase(1, 1000, 1500, 16, 8, 256, True, True, (299, -1), 50.0),
    BwdCase(1, 1000, 1500, 16, 8, 256, True, True, None, 50.0),
    BwdCase(1, 4200, 4200, 16, 8, 256, True, True, (4095, -1), 50.0),
    BwdCase(1, 2048, 2048, 16, 8, 256, True, True, (1023, -1), 5.0),
    BwdCase(1, 2048, 2048, 16, 8, 256, True, True, None, 5.0),
    BwdCase(8, 1024, 1024, 12, 12, 64, True, False, row=""),
    BwdCase(1, 1000, 1500, 12, 4, 64, True, True),
    BwdCase(2, 1024, 1024, 12, 12, 64, False, True),
    BwdCase(1, 8192, 8192, 32, 16, 128, True, True, (4095, -1), 50.0, row="",
            scale=GEMMA27_SCALE, tag=" 27B"),
    BwdCase(1, 8192, 8192, 32, 16, 128, True, True, None, 50.0, row="no_window",
            scale=GEMMA27_SCALE, tag=" 27B"),
    BwdCase(1, 1000, 1500, 32, 16, 128, True, True, (299, -1), 50.0, scale=GEMMA27_SCALE,
            tag=" 27B"),
    BwdCase(1, 2048, 2048, 32, 16, 128, True, True, (1023, -1), 5.0, scale=GEMMA27_SCALE,
            tag=" 27B"),
    BwdCase(1, 2048, 2048, 32, 16, 128, True, True, None, 5.0, scale=GEMMA27_SCALE,
            tag=" 27B"),
    BwdCase(1, 1000, 1500, 32, 16, 128, False, True, (8, 2), 50.0, scale=GEMMA27_SCALE,
            tag=" 27B"),
)


def _bwd_case_label(c: BwdCase) -> str:
    return (f"B={c.B}, " + (f"S={c.Sq}" if c.Sk == c.Sq else f"Sq={c.Sq}, Sk={c.Sk}")
            + f", H={c.H}, Hk={c.Hk}, D={c.D}, {'causal' if c.causal else 'not causal'}"
            + f"{', rope' if c.rope else ''}" + (f", softcap {c.cap:g}" if c.cap else "")
            + (f", q x{c.q_mult:g}" if c.q_mult != 1.0 else "")
            + (f", scale {c.scale:.4g}" if c.scale is not None else "")
            + (f", window {c.window}" if c.window else ""))


def _bwd_case_inputs(torch, g, c: BwdCase):
    """_bwd_inputs for case ``c``: (q, k, v, dout, lse, delta, cos, sin)."""
    llama = c.D == 128 and c.tag is None
    return _bwd_inputs(torch, g, c.B, c.Sq, c.Sk, c.causal, c.rope, c.H, c.Hk, c.D,
                       window=c.window, softcap=c.cap, scale=c.scale,
                       theta=500000.0 if llama else 10000.0, q_mult=c.q_mult)


def check_k9_k10(torch, checks, rows):
    """K9 (dq, and R(q) for K10) and K10 (dk, dv per query head, fp32, from
    K9's R(q)) against the plain version on the same inputs (out and lse
    from K4 with the same window and cap) at BWD_CASES; each output row
    held to 2^-6 of its largest value plus the other kernels' floor of
    1e-6, R(q) bitwise equal to rope_rotate, and a second launch of each
    bitwise equal to the first (no atomics).  A dq row of a query that sees
    one key (query 0 under the causal mask without shift) has a true
    gradient of 0: its ds = p (dp - delta) with dp = delta up to fp32
    summation order, so both sides give rounding noise there (0.988 of the
    1e-6 floor on an NVIDIA H100 80GB HBM3 at 700 W); those rows alone get a
    floor of 2^-12 of dq's largest value (``one_key_floor``).  Times: CUDA
    events over 20 launches, and CUDA-graph replays (``graph_ms``).  Bounds:
    dq 3 GEMMs and dk/dv 4 of 2*D flops per (query, key) pair the masks
    keep.  A row's case also times the plain version and SDPA's backward
    (device time by torch.profiler; the window as a boolean mask): the
    library call without a cap, and beside a capped row as
    ``sdpa_nocap_ms`` (a different function: no single PyTorch call
    applies the softcap)."""
    import torch.nn.functional as F

    from flash_attn_tpu_torch.ops import flash_bwd as fb
    from flash_attn_tpu_torch.ops import flash_fwd as ff
    from flash_attn_tpu_torch.ops.rope import rope_rotate

    g = torch.Generator(device="cuda").manual_seed(SEED + 12)
    worst = {}
    for c in BWD_CASES:
        q, k, v, dout, lse, delta, cos, sin = _bwd_case_inputs(torch, g, c)
        D, scale = c.D, c.softmax_scale
        args = (q, k, v, dout, lse, delta, c.causal, scale, cos, sin, c.window, c.cap)
        tail = (k, v, dout, lse, delta, c.causal, scale, c.window, c.cap)
        label = _bwd_case_label(c)
        suffix = c.suffix
        case_worst = {"K9": 0.0, "K10": 0.0}
        dq, rq, dk, dv, res = _bwd_case(torch, checks, case_worst, label, args, tail, c.causal)
        for key, err in case_worst.items():
            worst[key + suffix] = max(worst.get(key + suffix, 0.0), err)
        kargs = (rq, *tail)
        live = ff.live_pairs(None, c.causal, c.Sq, c.Sk, "cuda", c.window)
        pairs = int(live.sum())
        gemm = 2 * D * c.B * c.H * pairs  # one product over the live pairs
        ins = (q.numel() + dout.numel() + k.numel() + v.numel()) * 2 + (lse.numel() + delta.numel()) * 4
        if c.rope:
            ins += 2 * cos.numel() * 4
        ms9 = cuda_ms(torch, lambda: fb.flash_bwd_dq_cuda(*args))
        ms10 = cuda_ms(torch, lambda: fb.flash_bwd_dkv_cuda(*kargs))
        g9 = graph_ms(torch, lambda: fb.flash_bwd_dq_cuda(*args))
        g10 = graph_ms(torch, lambda: fb.flash_bwd_dkv_cuda(*kargs))
        b9 = bound(ins + dq.numel() * 4, 3 * gemm)
        b10 = bound(ins + 2 * c.B * c.H * c.Sk * D * 4, 4 * gemm)
        say(f"  K9 {label}: {res['K9']} | {ms9:.4f} ms, graph {g9:.4f} "
            f"({3 * gemm / g9 / 1e9:.1f} TFLOP/s on {pairs} live pairs a head), bound "
            f"{b9[0]:.4f} ({b9[1]})")
        say(f"  K10 {label}: {res['K10']} | {ms10:.4f} ms, graph {g10:.4f} "
            f"({4 * gemm / g10 / 1e9:.1f} TFLOP/s), bound {b10[0]:.4f} ({b10[1]})")
        if c.row is not None:
            plain_ms = cuda_ms(torch, lambda: bwd_plain(args), iters=2, warmup=1)
            qt = (q if cos is None else rope_rotate(q, cos, sin)).transpose(1, 2).contiguous()
            qt.requires_grad_(True)
            kt = k.transpose(1, 2).contiguous().requires_grad_(True)
            vt = v.transpose(1, 2).contiguous().requires_grad_(True)
            mask = dict(is_causal=c.causal) if c.window is None else dict(attn_mask=live[0])
            o = F.scaled_dot_product_attention(qt, kt, vt, scale=scale, enable_gqa=True, **mask)
            do_t = dout.transpose(1, 2).contiguous()

            def lib_call():
                return torch.autograd.grad(o, (qt, kt, vt), do_t, retain_graph=True)
            lib_events = cuda_ms(torch, lib_call, iters=5, warmup=1)
            # device time only: the event time takes autograd's host work in
            sdpa_ms, backend, names = sdpa_bwd_device_ms(torch, lib_call, calls=5)
            del qt, kt, vt, o
            sdpa = "not measured" if sdpa_ms is None else f"{sdpa_ms:.4f}"
            lib = ("library none (no single PyTorch call applies the softcap); SDPA's backward "
                   "without it, a different function," if c.cap else
                   "library (the backward of SDPA on rotated q: dq, dk, dv in one call, one "
                   "number for both rows)")
            say(f"    K9 + K10 {ms9 + ms10:.4f} ms, graph {g9 + g10:.4f}; plain (both passes, "
                f"one call) {plain_ms:.4f}; {lib} device time {sdpa} by torch.profiler, events "
                f"{lib_events:.4f}; backend {backend}: {', '.join(names)[:300]}")
            for key, name, ms, gms, b, line in (("K9", "dq", ms9, g9, b9, 127),
                                                 ("K10", "dk/dv", ms10, g10, b10, 194)):
                entry = dict(ms=ms, graph_ms=gms, plain_ms=plain_ms, bound_ms=b[0],
                             bound_by=b[1])
                entry.update(dict(library_ms=None, sdpa_nocap_ms=sdpa_ms) if c.cap
                             else dict(library_ms=sdpa_ms))
                if not c.row:
                    rows[key + suffix] = dict(
                        name=f"flash_bwd {name} pass ({label})",
                        source="flash_attn_tpu_torch/csrc/flash_bwd.cu",
                        replaces=f"flash_attn_tpu/ops/flash_bwd.py:{line}", **entry)
                else:
                    rows[key + suffix][c.row] = entry
            if c.row:
                main = rows["K9" + suffix], rows["K10" + suffix]
                say(f"  K9/K10{suffix}: {c.row} / the row's time K9 "
                    f"{ms9 / main[0]['ms']:.3f}, K10 {ms10 / main[1]['ms']:.3f}")
        del q, k, v, dout, lse, delta, dq, rq, dk, dv, live
        torch.cuda.empty_cache()
    for key, err in worst.items():
        rows[key]["max_abs_err"] = err


def _paged_inputs(torch, kv, g, page, B=8, H=32, Hk=8, S=4096, D=128):
    """A pool of B sequences' worth of pages of ``page`` tokens plus the
    null page, page ids a seeded permutation of the pool, and ragged
    lengths including S, 1, a page boundary (1024) and 0."""
    from flash_attn_tpu_torch.ops.quant import quantize_kv

    mp = S // page
    P = B * mp + 1
    q = torch.randn((B, H, D), generator=g, device="cuda", dtype=torch.bfloat16)
    kf = torch.randn((P, Hk, page, D), generator=g, device="cuda", dtype=torch.bfloat16)
    vf = torch.randn((P, Hk, page, D), generator=g, device="cuda", dtype=torch.bfloat16)
    perm = torch.randperm(P - 1, generator=g, device="cuda") + 1
    table = perm[:B * mp].reshape(B, mp).to(torch.int32).contiguous()
    lens = torch.randint(1, S + 1, (B,), generator=g, device="cuda", dtype=torch.int32)
    lens[:4] = torch.tensor([S, 1, 1024, 0], dtype=torch.int32)[:B]
    if kv == "bf16":
        return q, kf, vf, None, None, table, lens
    kq, ks, vq, vs = quantize_kv(kf, vf, kv)
    return q, kq, vq, ks[..., 0].contiguous(), vs[..., 0].contiguous(), table, lens


def _mode_args(dec, kv_dtype):
    """(clamped, clamp2) of the default softmax mode for this KV type."""
    return dec._default_softmax_mode(kv_dtype) == "clamped", dec._clamp2(kv_dtype)


def _k8_times(torch, pd, F, q, k, v, ks, vs, table, lens, args, window=None):
    """K8's times at one set of lengths (fp8, pages of 128): the kernel by
    events and as a replayed CUDA graph (one launch: the walk and the
    in-kernel merge), paged_flash_decode as called as a graph, the library
    call (SDPA on the gathered, dequantized cache; with a ``window`` as a
    boolean mask) by events, and the bound (on the rows in the window)."""
    S = table.shape[1] * k.shape[2]
    B, H, D = q.shape
    kc, vc = pd._gather(k, table), pd._gather(v, table)
    kcs, vcs = pd._gather(ks, table), pd._gather(vs, table)
    kd, vd = _dequant(kc, kcs), _dequant(vc, vcs)
    if window is None:
        mask = (torch.arange(S, device="cuda")[None, :] < lens[:, None].long())[:, None, None, :]
        nbytes = k1_bytes(kc, lens, kcs)
        live_rows = int(lens.long().clamp(0, S).sum())
    else:
        mask, live_rows = _window_mask(torch, lens, 1, S, window)
        nbytes = 2 * k.shape[1] * int(_window_rows(torch, lens, 1, S, window).sum()) * (D + 4)
    nbytes += 2 * q.numel() * 2 + lens.numel() * 4 + table.numel() * 4
    b_ms, b_by = bound(nbytes, 4 * H * D * live_rows)
    res = dict(ms=cuda_ms(torch, lambda: pd.paged_flash_decode_cuda(*args)),
               graph_ms=graph_ms(torch, lambda: pd.paged_flash_decode_cuda(*args)),
               call_graph_ms=graph_ms(torch, lambda: pd.paged_flash_decode(
                   q, k, v, table, lens, k_scale=ks, v_scale=vs, window=window)),
               library_ms=cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                   q[:, :, None, :], kd, vd, attn_mask=mask, enable_gqa=True)),
               bound_ms=b_ms, bound_by=b_by)
    del kc, vc, kcs, vcs, kd, vd
    return res


def _k8_decode_case(torch, checks, label, q, k, v, ks, vs, table, lens, window=None):
    """K8 in decode mode with the live splits it plans against its plain
    version (each row to two bf16 ulps of its largest, the LSE to 1e-3)
    and against K1 on the same content copied into a contiguous cache
    (both with ``window``, if given); an
    empty sequence must give out 0 and lse <= -1e29, and the call must be
    one launch of K8 and none of K1m (the splits merged in the kernel).
    Returns (max |err|, K8's args, its splits, K1's args)."""
    from flash_attn_tpu_torch.ops import decode as dec
    from flash_attn_tpu_torch.ops import paged_decode as pd
    from flash_attn_tpu_torch.ops.lse import lse_merge_cuda

    B, H, D = q.shape
    Hk, page = k.shape[1], k.shape[2]
    S = table.shape[1] * page
    clamped, clamp2 = _mode_args(dec, k.dtype)
    nsplit, split_len = pd._plan(B, Hk, H // Hk, 1, S, None, window)
    args = (q, k, v, ks, vs, table, lens, D ** -0.5, clamped, clamp2, 1, nsplit, split_len,
            window)
    before = (pd.paged_flash_decode_cuda.launches, lse_merge_cuda.launches)
    got, glse = pd.paged_flash_decode(q, k, v, table, lens, k_scale=ks, v_scale=vs,
                                      window=window, return_lse=True)
    one_launch = (pd.paged_flash_decode_cuda.launches - before[0],
                  lse_merge_cuda.launches - before[1]) == (1, 0)
    ref, rlse = plain_merge(*pd.paged_flash_decode_plain(*args), torch.bfloat16)
    kc, vc = pd._gather(k, table), pd._gather(v, table)
    kcs = None if ks is None else pd._gather(ks, table)
    vcs = None if vs is None else pd._gather(vs, table)
    k1_args = (q, kc, vc, kcs, vcs, lens, D ** -0.5, clamped, clamp2,
               *dec._splits(B, Hk, S, None))
    k1 = dec.flash_decode(q, kc, vc, k_scale=kcs, v_scale=vcs, kv_length=lens,
                          kv_layout="bhsd", window=window)
    torch.cuda.synchronize()
    err, share = row_err(got, ref)
    _, share_k1 = row_err(got, k1)
    live = lens > 0
    # fp32 sums of at most S terms in another order: far below 1e-3
    lerr = float((glse - rlse)[live].abs().max())
    empty = bool((got[~live] == 0).all() and (glse[~live] <= -1e29).all())
    ok = (checks.check(f"{label} out", share, 1.0)
          & checks.check(f"{label} lse", lerr, 1e-3)
          & checks.check(f"{label} vs K1 on the same content", share_k1, 1.0))
    if not empty:
        checks.failed.append(f"{label}: the empty sequence is not out 0, lse <= -1e29")
    if not one_launch:
        checks.failed.append(f"{label}: paged_flash_decode was not one launch of K8 and none "
                             "of K1m")
    say(f"  {label} ({nsplit} live splits, merged in the kernel): max_abs_err {err:.3e} "
        f"({share:.3f} of its row's tol; vs K1 {share_k1:.3f}), lse err {lerr:.3e} (tol "
        f"1e-3), empty sequence {'ok' if empty else 'FAIL'}, one launch "
        f"{'ok' if one_launch else 'FAIL'} {'ok' if ok and empty and one_launch else 'FAIL'}")
    return err, args, nsplit, k1_args


def check_k8(torch, checks, rows):
    """K8 in decode mode at B=8, H=32, Hk=8, D=128, 32 pages of 128 (then 8
    of 512) per sequence, bf16/int8/fp8, with the live splits it plans (one
    launch, merged in the kernel), against its plain version and against K1
    on the same content copied into a contiguous cache; the fp8 point at
    pages of 128 carries its times, also at the paged engine's lengths
    (576-1056: a 512-token prefix, a 64-512 suffix and up to 32 generated
    tokens).  Then K8c (chunk mode) at B=1 over pages of 128, against the
    plain version with the same splits; the fp8 points at T=128 carry their
    times."""
    import torch.nn.functional as F

    from flash_attn_tpu_torch.ops import decode as dec
    from flash_attn_tpu_torch.ops import paged_decode as pd

    g = torch.Generator(device="cuda").manual_seed(SEED + 10)
    worst = worst_c = 0.0
    for page in (128, 512):
        for kv in ("bf16", "int8", "fp8"):
            q, k, v, ks, vs, table, lens = _paged_inputs(torch, kv, g, page)
            label = f"K8 decode {kv} page={page}"
            err, args, nsplit, k1_args = _k8_decode_case(torch, checks, label, q, k, v, ks,
                                                         vs, table, lens)
            worst = max(worst, err)
            ms = cuda_ms(torch, lambda: pd.paged_flash_decode_cuda(*args))
            k1_ms = cuda_ms(torch, lambda: dec.flash_decode_cuda(*k1_args))
            say(f"    {label}: {ms:.4f} ms, K1 on the same content {k1_ms:.4f} (without its "
                f"K1m merge)")
            if page == 128 and kv == "fp8":
                t = _k8_times(torch, pd, F, q, k, v, ks, vs, table, lens, args)
                t["plain_ms"] = cuda_ms(torch, lambda: pd.paged_flash_decode_plain(*args),
                                        iters=3)
                say(f"    K8 decode fp8 page=128, lengths {lens.tolist()}: {t['ms']:.4f} ms "
                    f"(graph {t['graph_ms']:.4f}; as called, graph {t['call_graph_ms']:.4f}), "
                    f"plain {t['plain_ms']:.4f}, library (SDPA on the gathered, dequantized "
                    f"cache) {t['library_ms']:.4f}, bound {t['bound_ms']:.4f} ({t['bound_by']})")
                lens_e = torch.randint(576, 1057, (q.shape[0],), generator=g, device="cuda",
                                       dtype=torch.int32)
                args_e = (*args[:6], lens_e, *args[7:])
                got_e = pd.paged_flash_decode(q, k, v, table, lens_e, k_scale=ks, v_scale=vs)
                ref_e, _ = plain_merge(*pd.paged_flash_decode_plain(*args_e), torch.bfloat16)
                torch.cuda.synchronize()
                _, share_e = row_err(got_e, ref_e)
                checks.check(f"{label} at the engine's lengths out", share_e, 1.0)
                te = _k8_times(torch, pd, F, q, k, v, ks, vs, table, lens_e, args_e)
                say(f"    K8 decode fp8 page=128 at the engine's lengths {lens_e.tolist()}: "
                    f"{share_e:.3f} of its row's tol | {te['ms']:.4f} ms (graph "
                    f"{te['graph_ms']:.4f}; as called, graph {te['call_graph_ms']:.4f}), "
                    f"library {te['library_ms']:.4f}, bound {te['bound_ms']:.4f} "
                    f"({te['bound_by']})")
                rows["K8"] = dict(name="paged_decode, decode mode (B=8, H=32, Hk=8, page=128, "
                                       f"32 pages/seq, fp8 KV, {nsplit} live splits)",
                                  source="flash_attn_tpu_torch/csrc/paged_decode.cu",
                                  replaces="flash_attn_tpu/ops/paged_decode.py:47",
                                  k1_ms=k1_ms, **t,
                                  also=dict(label="the paged engine's lengths 576-1056", **te))
            del q, k, v, ks, vs
    # chunk mode (K8c): one sequence over pages of 128; T=128 at 640 (512
    # resident + the chunk) and at 1024 (the last piece of phase 7's longest
    # suffix), a ragged T=123 and T=4 (16 rows)
    Hk, H, D = 8, 32, 128
    times = {}
    for kv, T, kv_len, mode in (("bf16", 128, 640, None), ("int8", 128, 640, None),
                                ("fp8", 128, 640, None), ("fp8", 128, 1024, None),
                                ("fp8", 123, 1019, None), ("int8", 4, 700, "online"),
                                ("int8", 4, 700, "clamped")):
        _, k, v, ks, vs, table, _ = _paged_inputs(torch, kv, g, 128, B=1)
        S = table.shape[1] * 128
        qc = torch.randn((1, T, H, D), generator=g, device="cuda", dtype=torch.bfloat16)
        lens = torch.tensor([kv_len], dtype=torch.int32, device="cuda")
        mode = mode or dec._default_softmax_mode(k.dtype)
        clamped, clamp2 = mode == "clamped", dec._clamp2(k.dtype)
        q2 = qc.reshape(1, T, Hk, H // Hk, D).transpose(1, 2).reshape(1, Hk * T * (H // Hk), D).contiguous()
        nsplit = dec._chunk_splits(1, Hk, T * H // Hk, S, None)
        args = (q2, k, v, ks, vs, table, lens, D ** -0.5, clamped, clamp2, T, nsplit, None)
        got, glse = pd.paged_flash_decode_chunk(qc, k, v, table, lens, k_scale=ks,
                                                v_scale=vs, return_lse=True, softmax_mode=mode)
        ref2, rlse2 = plain_merge(*pd.paged_flash_decode_plain(*args), torch.bfloat16)
        torch.cuda.synchronize()
        ref = ref2.reshape(1, Hk, T, H // Hk, D).transpose(1, 2).reshape(1, T, H, D)
        rlse = rlse2.reshape(1, Hk, T, H // Hk).transpose(1, 2).reshape(1, T, H)
        err, share = row_err(got, ref)
        lerr = float((glse - rlse).abs().max())
        label = f"K8c {kv} T={T} kv_len={kv_len} ({mode}, {nsplit} splits)"
        ok = checks.check(f"{label} out", share, 1.0) & checks.check(f"{label} lse", lerr, 1e-3)
        worst_c = max(worst_c, err)
        ms = cuda_ms(torch, lambda: pd.paged_flash_decode_cuda(*args))
        say(f"  {label}: max_abs_err {err:.3e} ({share:.3f} of its row's tol), lse err "
            f"{lerr:.3e} (tol 1e-3) {'ok' if ok else 'FAIL'} | {ms:.4f} ms")
        if kv == "fp8" and T == 128:
            kd = (pd._gather(k, table).float() * pd._gather(ks, table)[..., None])[:, :, :kv_len].bfloat16()
            vd = (pd._gather(v, table).float() * pd._gather(vs, table)[..., None])[:, :, :kv_len].bfloat16()
            qt = qc.transpose(1, 2)
            cmask = (torch.arange(kv_len, device="cuda")[None, :]
                     <= torch.arange(T, device="cuda")[:, None] + kv_len - T)
            pairs = sum(kv_len - (T - 1) + t for t in range(T))
            nbytes = (2 * Hk * kv_len * (D + 4) + 2 * qc.numel() * 2 + glse.numel() * 4
                      + table.numel() * 4 + 4)
            times[kv_len] = _chunk_times(
                torch, lambda: pd.paged_flash_decode_cuda(*args),
                lambda: pd.paged_flash_decode_chunk(qc, k, v, table, lens, k_scale=ks,
                                                    v_scale=vs),
                lambda: F.scaled_dot_product_attention(qt, kd, vd, attn_mask=cmask,
                                                       enable_gqa=True),
                nbytes, 4 * H * D * pairs)
            _say_times(f"K8c fp8 T=128 kv_len={kv_len} "
                       f"({4 * H * D * pairs / times[kv_len]['ms'] / 1e9:.1f} TFLOP/s)",
                       times[kv_len])
            if kv_len == 640:
                plain_ms = cuda_ms(torch, lambda: pd.paged_flash_decode_plain(*args), iters=3)
                say(f"    plain {plain_ms:.4f}")
            del kd, vd
        del k, v, ks, vs
    rows["K8c"] = dict(name="paged_decode, chunk mode (B=1, T=128, H=32, Hk=8, "
                            "kv_len=640, page=128, fp8 KV)",
                       source="flash_attn_tpu_torch/csrc/chunk_attn.cu",
                       replaces="flash_attn_tpu/ops/paged_decode.py:47",
                       plain_ms=plain_ms, **times[640],
                       also=dict(label="kv_len=1024, the last piece of a 512-token suffix",
                                 **times[1024]))
    rows["K8"]["max_abs_err"] = worst
    rows["K8c"]["max_abs_err"] = worst_c


# --- Gemma-2-9B's shapes: head_dim 256, the sliding window, the softcap ----
# --- and Gemma-2-27B's: head_dim 128, the scale 144^-1/2 ---------------------

# the plain versions' score tensors ([B, heads, Sq, Sk] fp32) at most this
# large: a larger call runs them over groups of heads (whole GQA groups)
PLAIN_SCORE_BYTES = 2 ** 32


def _head_groups(B, Sq, Sk, H, Hk):
    """Query-head slices of whole GQA groups whose scores fit
    PLAIN_SCORE_BYTES (one slice, all H heads, when they do)."""
    G = H // Hk
    per = max(1, PLAIN_SCORE_BYTES // (B * G * Sq * Sk * 4)) * G
    return [slice(h, min(h + per, H)) for h in range(0, H, per)]


def _group_tail(tail, hs, bias_at):
    """``tail`` (the arguments after the tensors split by heads) for query
    heads ``hs``: the bias ([B, H, Sq, Sk] view, at ``bias_at``) sliced
    alike."""
    tail = list(tail)
    if len(tail) > bias_at and tail[bias_at] is not None:
        tail[bias_at] = tail[bias_at][:, hs]
    return tail


def _cat_groups(outs, first_dim):
    """The per-head-group results of a plain version joined: the first on
    ``first_dim``, the rest on the heads (dim 1); None stays None."""
    import torch

    return tuple(None if outs[0][i] is None else
                 torch.cat([o[i] for o in outs], dim=first_dim if i == 0 else 1)
                 for i in range(len(outs[0])))


def fwd_plain(args, **kw):
    """flash_fwd_plain on ``args`` (flash_fwd_cuda's) and its keywords
    (ALiBi slopes, probs, verify), over groups of whole GQA groups of
    query heads (_head_groups): each head's values are the one call's, in a
    fraction of the memory (a bias and the slopes sliced by heads, dropout
    keyed on each head's own index)."""
    from flash_attn_tpu_torch.ops import flash_fwd as ff

    q, k, v = args[:3]
    B, Sq, H, _ = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    parts = _head_groups(B, Sq, Sk, H, Hk)
    if len(parts) == 1:
        return ff.flash_fwd_plain(*args, **kw)
    G = H // Hk
    outs = [ff.flash_fwd_plain(q[:, :, hs], k[:, :, hs.start // G:hs.stop // G],
                               v[:, :, hs.start // G:hs.stop // G], *_group_tail(args[3:], hs, 8),
                               head0=hs.start, **_group_kw(kw, hs))
            for hs in parts]
    return _cat_groups(outs, 2)


def _group_kw(kw, hs):
    """A plain version's keywords for the query heads ``hs``: the ALiBi
    slopes sliced."""
    return {n: x[hs] if n == "alibi" and x is not None else x for n, x in kw.items()}


def bwd_plain(args, **kw):
    """flash_bwd_plain on ``args`` (flash_bwd_dq_cuda's) and its keywords
    (ALiBi slopes, want_ds), as fwd_plain splits flash_fwd_plain."""
    from flash_attn_tpu_torch.ops import flash_bwd as fb

    q, k, v, dout, lse, delta = args[:6]
    B, Sq, H, _ = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    parts = _head_groups(B, Sq, Sk, H, Hk)
    if len(parts) == 1:
        return fb.flash_bwd_plain(*args, **kw)
    G = H // Hk
    outs = []
    for hs in parts:
        ks = slice(hs.start // G, hs.stop // G)
        outs.append(fb.flash_bwd_plain(q[:, :, hs], k[:, :, ks], v[:, :, ks], dout[:, :, hs],
                                       lse[:, hs], delta[:, hs], *_group_tail(args[6:], hs, 7),
                                       head0=hs.start, **_group_kw(kw, hs)))
    return _cat_groups(outs, 2)


def _k4_case(torch, checks, label, q, k, v, cos, sin, clamped, window, timed=False,
             scale=GEMMA_SCALE):
    """K4 with the Gemma softcap and ``scale`` against its plain version
    (each row to two bf16 ulps of its largest, the LSE to 1e-3, as check_k4
    holds it; fwd_plain); with ``timed`` also the kernel's time, the plain version's,
    SDPA's without the cap (a different function: no single PyTorch call
    applies the softcap; the window as a boolean mask) and the bound on
    the live pairs.  Returns (max |err|, the times or None)."""
    import torch.nn.functional as F

    from flash_attn_tpu_torch.ops import flash_fwd as ff
    from flash_attn_tpu_torch.ops.rope import rope_rotate

    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    args = (q, k, v, True, scale, cos, sin, clamped, None, window, GEMMA_CAP)
    out, lse = ff.flash_fwd(q, k, v, causal=True, scale=scale, window=window,
                            logit_softcap=GEMMA_CAP, rope_cos=cos, rope_sin=sin,
                            softmax_mode="clamped" if clamped else "online")
    rout, rlse = fwd_plain(args)
    torch.cuda.synchronize()
    err, share = row_err(out, rout)
    lerr = float((lse - rlse).abs().max())
    ok = checks.check(f"{label} out", share, 1.0) & checks.check(f"{label} lse", lerr, 1e-3)
    line = (f"  {label}: max_abs_err {err:.3e} ({share:.3f} of its row's tol), lse err "
            f"{lerr:.3e} (tol 1e-3) {'ok' if ok else 'FAIL'}")
    del out, lse, rout, rlse
    times = None
    pairs = int(ff.live_pairs(None, True, Sq, Sk, "cuda", window).sum())
    flops = 4 * B * H * D * pairs
    if timed:
        ms = cuda_ms(torch, lambda: ff.flash_fwd_cuda(*args))
        plain_ms = cuda_ms(torch, lambda: fwd_plain(args), iters=1, warmup=1)
        qr = rope_rotate(q, cos, sin).transpose(1, 2).contiguous()
        kt, vt = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
        if window is None:
            sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qr, kt, vt, is_causal=True, scale=scale, enable_gqa=True)
        else:
            mask = ff.live_pairs(None, True, Sq, Sk, "cuda", window)[0]
            sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qr, kt, vt, attn_mask=mask, scale=scale, enable_gqa=True)
        sdpa_ms = cuda_ms(torch, sdpa, iters=5)
        del qr, kt, vt
        nbytes = q.numel() * 2 * 2 + k.numel() * 2 * 2 + cos.numel() * 4 * 2 + B * H * Sq * 4
        b_ms, b_by = bound(nbytes, flops)
        times = dict(ms=ms, plain_ms=plain_ms, sdpa_nocap_ms=sdpa_ms, bound_ms=b_ms,
                     bound_by=b_by, live_pairs=pairs)
        line += (f" | {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s on {pairs} live pairs), plain "
                 f"{plain_ms:.4f}, library none (no single PyTorch call applies the softcap; "
                 f"SDPA without it, a different function: {sdpa_ms:.4f}), bound {b_ms:.4f} "
                 f"({b_by})")
    say(line)
    return err, times


def check_k4_gemma(torch, checks, rows, key="K4 d256", H=16, Hk=8, D=256, scale=GEMMA_SCALE,
                   seed=SEED + 30):
    """K4 at Gemma-2-9B's prefill shape (the defaults): D=256, H=16, Hk=8,
    S=8192, causal, clamped, softcap 50, scale 1/16, q rotated in the
    kernel, with the sliding window (4095, -1) and without (the "K4 d256"
    row; the windowed call should take near the share of live pairs,
    ~0.75, of the causal one: the tiles below the window are skipped, not
    masked); then at small odd shapes (S=891, a shifted Sq=1000 Sk=1500)
    in both softmax modes, with a window of 300 and without.  Gemma-2-27B
    passes D=128, H=32, Hk=16, scale 1/12 and its row, "K4 27B" (K4's
    head_dim 128 kLocal instance)."""
    from flash_attn_tpu_torch.ops.rope import rope_cos_sin

    g = torch.Generator(device="cuda").manual_seed(seed)
    worst, times = 0.0, {}
    for Sq, Sk, timed in ((8192, 8192, True), (891, 891, False), (1000, 1500, False)):
        q = torch.randn((1, Sq, H, D), generator=g, device="cuda", dtype=torch.bfloat16)
        k = torch.randn((1, Sk, Hk, D), generator=g, device="cuda", dtype=torch.bfloat16)
        v = torch.randn((1, Sk, Hk, D), generator=g, device="cuda", dtype=torch.bfloat16)
        cos, sin = rope_cos_sin(torch.arange(Sq, device="cuda")[None] + (Sk - Sq), D, 10000.0)
        wide = (GEMMA_WINDOW - 1, -1) if timed else (299, -1)
        cases = ((True, wide), (True, None)) if timed else (
            (True, wide), (False, wide), (True, None), (False, None))
        for clamped, window in cases:
            label = (f"K4 D={D} {'clamped' if clamped else 'online'} S={Sq}"
                     + (f" Sk={Sk}" if Sk != Sq else "") + f" H={H} Hk={Hk} softcap 50 "
                     + f"scale {scale:.4g} " + (f"window {window}" if window else "no window"))
            err, t = _k4_case(torch, checks, label, q, k, v, cos, sin, clamped, window, timed,
                              scale)
            worst = max(worst, err)
            if t:
                times[window is not None] = t
        del q, k, v
        torch.cuda.empty_cache()
    w, nw = times[True], times[False]
    say(f"  K4 D={D} S=8192: windowed / causal time {w['ms'] / nw['ms']:.3f} (live pairs "
        f"{w['live_pairs'] / nw['live_pairs']:.3f})")
    rows[key] = dict(
        name=f"flash_fwd (B=1, S=8192, H={H}, Hk={Hk}, D={D}, causal, rope, clamped, softcap 50, "
             f"scale {scale:.4g}, window (4095, -1))",
        source="flash_attn_tpu_torch/csrc/flash_fwd.cu",
        replaces="flash_attn_tpu/ops/flash_fwd.py:221", max_abs_err=worst,
        ms=w["ms"], plain_ms=w["plain_ms"], library_ms=None, bound_ms=w["bound_ms"],
        bound_by=w["bound_by"], sdpa_nocap_ms=w["sdpa_nocap_ms"],
        no_window=dict(ms=nw["ms"], plain_ms=nw["plain_ms"], sdpa_nocap_ms=nw["sdpa_nocap_ms"],
                       bound_ms=nw["bound_ms"], bound_by=nw["bound_by"]))


def _gemma_decode_inputs(torch, kv, g, B=8, H=16, Hk=8, S=8192, D=256):
    """Gemma-2-9B's decode step: q and a quantized BHSD cache, lengths
    up to ~8000 (one full past the window, one of 1, one of 4096)."""
    q, k, v, ks, vs, lens = _decode_inputs(torch, kv, g, B=B, H=H, Hk=Hk, S=S, D=D)
    lens.copy_(torch.randint(1, 8001, (B,), generator=g, device="cuda", dtype=torch.int32))
    lens[0], lens[1], lens[2] = 8000, 1, GEMMA_WINDOW
    return q, k, v, ks, vs, lens


def _k1m_row(torch, checks, shape, outs, lses, idle=None):
    """K1m on split partials (outs [n, B, rows, D], lses [n, B, rows]) into
    bf16 against lse_merge (each row to two bf16 ulps of its largest, the
    LSE to 1e-3; slot ``idle``, if given, must give out 0 and lse <=
    -1e29), timed as a replayed CUDA graph beside the plain merge and the
    bound: a kernel row."""
    from flash_attn_tpu_torch.ops.lse import lse_merge, lse_merge_cuda

    got, glse = lse_merge_cuda(outs, lses, torch.bfloat16)
    ref, rlse = lse_merge(outs, lses, axis=0)
    torch.cuda.synchronize()
    err, share = row_err(got, ref.to(torch.bfloat16))
    lerr = float((glse - rlse).abs().max())
    label = f"K1m {shape}"
    ok = checks.check(f"{label} out", share, 1.0) & checks.check(f"{label} lse", lerr, 1e-3)
    if idle is not None and not bool((got[idle] == 0).all() and (glse[idle] <= -1e29).all()):
        checks.failed.append(f"{label}: the idle slot is not out 0, lse <= -1e29")
        ok = False
    ms = graph_ms(torch, lambda: lse_merge_cuda(outs, lses, torch.bfloat16))
    plain_ms = cuda_ms(torch, lambda: lse_merge(outs, lses, axis=0)[0].to(torch.bfloat16))
    nbytes = outs.numel() * 4 + lses.numel() * 4 + outs[0].numel() * 2 + lses[0].numel() * 4
    b_ms, b_by = bound(nbytes, 2 * outs.numel())
    n = outs.shape[0]
    say(f"  {label} ({n} splits -> bf16): max_abs_err {err:.3e} ({share:.3f} of its row's "
        f"tol), lse err {lerr:.3e} (tol 1e-3) {'ok' if ok else 'FAIL'} | {ms:.4f} ms (CUDA "
        f"graph), plain {plain_ms:.4f}, library none, bound {b_ms:.4f} ({b_by})")
    return dict(name=f"lse_merge ({n} splits of {shape} fp32 partials -> bf16)",
                source="flash_attn_tpu_torch/csrc/lse_merge.cu",
                replaces="flash_attn_tpu/ops/lse.py:23", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, library_ms=None, bound_ms=b_ms, bound_by=b_by)


def check_k1_gemma(torch, checks, rows, key="K1 d256", H=16, Hk=8, D=256, scale=GEMMA_SCALE,
                   kvs=("int8", "fp8"), k1m_key="K1m d256", seed=SEED + 31):
    """K1 at Gemma-2-9B's decode step (the defaults): D=256, B=8, H=16,
    Hk=8, capacity 8192, int8 and fp8 KV (online: the cap reaches the fp8
    ceiling), softcap 50, scale 1/16, lengths up to 8000, with window 4096
    (splits over each sequence's live walk) and without (splits over the
    capacity), each against its plain version as check_k1 holds it (the
    "K1 d256" row: fp8, windowed; the windowed call should take about half
    the unwindowed one); then K1m at D=256 on the windowed fp8 partials
    against lse_merge (the "K1m d256" row).  Gemma-2-27B passes D=128,
    H=32, Hk=16, scale 1/12, fp8 alone, no K1m row and its row, "K1 27B"
    (K1's window at head_dim 128)."""
    import torch.nn.functional as F

    from flash_attn_tpu_torch.ops import decode as dec

    g = torch.Generator(device="cuda").manual_seed(seed)
    worst = 0.0
    for kv in kvs:
        q, k, v, ks, vs, lens = _gemma_decode_inputs(torch, kv, g, H=H, Hk=Hk, D=D)
        B, H, D = q.shape
        Hk, S = k.shape[1], k.shape[2]
        clamped = dec._default_softmax_mode(k.dtype, GEMMA_CAP) == "clamped"
        clamp2 = dec._clamp2(k.dtype)
        times = {}
        for window in (GEMMA_WINDOW, None):
            reach = S if window is None else min(window, S)
            nsplit, split_len = dec._splits(B, Hk, reach, None)
            if window is not None:
                split_len = None
            args = (q, k, v, ks, vs, lens, scale, clamped, clamp2, nsplit, split_len,
                    1, "bhsd", window, GEMMA_CAP)
            call = lambda: dec.flash_decode(  # noqa: E731
                q, k, v, k_scale=ks, v_scale=vs, kv_length=lens, scale=scale,
                window=window, logit_softcap=GEMMA_CAP, kv_layout="bhsd", return_lse=True)
            got, glse = call()
            po, pl = dec.flash_decode_plain(*args)
            ref, rlse = plain_merge(po, pl, torch.bfloat16)
            torch.cuda.synchronize()
            err, share = row_err(got, ref)
            lerr = float((glse - rlse).abs().max())
            label = f"K1 D={D} H={H} Hk={Hk} {kv} {'window 4096' if window else 'no window'}"
            ok = checks.check(f"{label} out", share, 1.0) & checks.check(f"{label} lse", lerr, 1e-3)
            worst = max(worst, err)
            ms = cuda_ms(torch, lambda: dec.flash_decode_cuda(*args))
            call_ms = graph_ms(torch, call)
            plain_ms = cuda_ms(torch, lambda: dec.flash_decode_plain(*args), iters=3)
            kd, vd = _dequant(k, ks), _dequant(v, vs)
            pos = torch.arange(S, device="cuda")[None, :]
            live = pos < lens[:, None].long()
            if window is not None:
                live = live & (pos >= lens[:, None].long() - window)
            sdpa_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                q[:, :, None, :], kd, vd, attn_mask=live[:, None, None, :], scale=scale,
                enable_gqa=True))
            del kd, vd
            n_live = int(live.sum())
            nbytes = (2 * Hk * n_live * (D * k.element_size() + 4) + 2 * q.numel() * 2
                      + lens.numel() * 4)
            b_ms, b_by = bound(nbytes, 4 * H * D * n_live)
            times[window is not None] = dict(ms=ms, call_graph_ms=call_ms, plain_ms=plain_ms,
                                             sdpa_nocap_ms=sdpa_ms, bound_ms=b_ms, bound_by=b_by)
            say(f"  {label} ({'clamped' if clamped else 'online'}, {nsplit} splits"
                f"{' over the live walk' if window else ''}): max_abs_err {err:.3e} ({share:.3f} "
                f"of its row's tol), lse err {lerr:.3e} (tol 1e-3) {'ok' if ok else 'FAIL'} | "
                f"{ms:.4f} ms (as called with the K1m merge, graph {call_ms:.4f}), plain "
                f"{plain_ms:.4f}, library none (no single PyTorch call applies the softcap; "
                f"SDPA without it on the dequantized cache, a different function: "
                f"{sdpa_ms:.4f}), bound {b_ms:.4f} ({b_by}) on {n_live} live positions")
        w, nw = times[True], times[False]
        say(f"  K1 D={D} H={H} {kv}: windowed / unwindowed time {w['ms'] / nw['ms']:.3f}, as "
            f"called {w['call_graph_ms'] / nw['call_graph_ms']:.3f}")
        if kv == "fp8":
            rows[key] = dict(
                name=f"decode_bhsd (B=8, H={H}, Hk={Hk}, S=8192, D={D}, fp8 KV, online, softcap "
                     f"50, scale {scale:.4g}, window 4096)",
                source="flash_attn_tpu_torch/csrc/decode.cu",
                replaces="flash_attn_tpu/ops/decode.py:747", library_ms=None,
                **{x: w[x] for x in ("ms", "call_graph_ms", "plain_ms", "sdpa_nocap_ms",
                                     "bound_ms", "bound_by")},
                no_window={x: nw[x] for x in ("ms", "call_graph_ms", "plain_ms",
                                              "sdpa_nocap_ms", "bound_ms", "bound_by")})
        if kv == "fp8" and k1m_key:
            nsplit = dec._splits(B, Hk, GEMMA_WINDOW, None)[0]
            outs, lses = dec.flash_decode_cuda(q, k, v, ks, vs, lens, scale, clamped,
                                               clamp2, nsplit, None, 1, "bhsd", GEMMA_WINDOW,
                                               GEMMA_CAP)
            rows[k1m_key] = _k1m_row(torch, checks, f"B=8, H={H}, D={D}", outs, lses)
            del outs, lses
        del q, k, v, ks, vs
        torch.cuda.empty_cache()
    rows[key]["max_abs_err"] = worst


# Gemma-2-9B's and -27B's projections (K, N): wq, wk / wv, wo, w_gate /
# w_up, w_down
GEMMA_GEMMS = ((3584, 4096), (3584, 2048), (4096, 3584), (3584, 14336), (14336, 3584))
GEMMA27_GEMMS = ((4608, 4096), (4608, 2048), (4096, 4608), (4608, 36864), (36864, 4608))


def check_k3_gemma(torch, checks, rows, gemms=GEMMA_GEMMS, key="gemma", model="Gemma-2-9B",
                   seed=SEED + 32, ms=(8,), biased=()):
    """K3 at a model's widths (``gemms``; the defaults: Gemma-2-9B's) at
    each M of ``ms`` (8: the decode step), against its plain version as
    check_k3 holds it, M=8 also timed from CUDA-graph replays beside the
    library's two calls; the K3 row carries them under ``key`` (M=8's points
    as "KxN", the others' as "KxN M=m").  At the widths in ``biased`` the
    weight is also called as a ``BiasedWeight`` through quantized_matmul
    (Qwen-2's qkv bias, added after K3) and held to the plain product plus
    the bias by the same row rule."""
    from flash_attn_tpu_torch.ops import matmul as mm
    from flash_attn_tpu_torch.ops.quant import quantize_int8

    g = torch.Generator(device="cuda").manual_seed(seed)
    points = {}
    for K, N in gemms:
        wf = torch.randn((K, N), generator=g, device="cuda", dtype=torch.bfloat16) * 0.02
        wq, s = quantize_int8(wf, dims=(0,))
        wq, s = wq.contiguous(), s[0].contiguous()
        wbf = wq.bfloat16()
        del wf
        for M in ms:
            x = torch.randn((M, K), generator=g, device="cuda", dtype=torch.bfloat16)
            points[f"{K}x{N}" + ("" if M == 8 else f" M={M}")] = _q_point(
                torch, checks, f"K3 {model} M={M} K={K} N={N}",
                lambda: mm.matmul_int8_cuda(x, wq, s, torch.bfloat16),
                lambda: mm.matmul_int8_plain(x, wq, s, torch.bfloat16),
                lambda: torch.matmul(x, wbf) * s, "matmul, then the scales",
                M * K * 2 + K * N + N * 4 + M * N * 2, 2 * M * K * N, graph=M == 8)
            if (K, N) in biased:
                bias = torch.randn((N,), generator=g, device="cuda", dtype=torch.bfloat16) * 0.02
                got = mm.quantized_matmul(x, mm.BiasedWeight((wq, s), bias))
                ref = (mm.matmul_int8_plain(x, wq, s, torch.bfloat16).float()
                       + bias.float()).bfloat16()
                err, share = row_err(got, ref)
                ok = checks.check(f"K3 {model} M={M} K={K} N={N} + qkv bias", share, 1.0)
                say(f"  K3 {model} M={M} K={K} N={N} + qkv bias (quantized_matmul of a "
                    f"BiasedWeight): max_abs_err {err:.3e} ({share:.3f} of its row's tol) "
                    f"{'ok' if ok else 'FAIL'}")
        del wq, s, wbf
    rows["K3"][key] = dict(M=ms[0], **points)


# --- GPT-2 124M's shapes (BASELINE config 0): head_dim 64 -------------------

GPT2_H, GPT2_D, GPT2_S = 12, 64, 1024   # heads (= KV heads), head_dim, positions


def _gpt2_prompts(vocab):
    """Phase 12's 8 prompts of 64-512 tokens, from the seed."""
    import numpy as np

    rng = np.random.default_rng(SEED + 50)
    lens = rng.integers(64, 513, 8)
    return lens, [rng.integers(0, vocab, int(n)).tolist() for n in lens]


def _k4_point(torch, checks, label, q, k, v, causal, clamped, masks=None, cos=None, sin=None,
              timed=False, lib=None, graph=False):
    """K4 (GPT-2's head_dim 64, Qwen-2's 7 heads a KV head) against its
    plain version (each row to two bf16 ulps of its largest, the LSE to
    1e-3, as check_k4 holds it); with
    ``timed`` also the kernel's time, the plain version's, ``lib``'s (one
    SDPA call of the same function, or None) and the bound on the live
    pairs, and with ``graph`` the kernel's and ``lib``'s times from
    CUDA-graph replays.  Returns (max |err|, the times or None)."""
    from flash_attn_tpu_torch.ops import flash_fwd as ff

    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    args = (q, k, v, causal, D ** -0.5, cos, sin, clamped, masks)
    kw = masks._asdict() if masks is not None else {}
    out, lse = ff.flash_fwd(q, k, v, causal=causal, rope_cos=cos, rope_sin=sin,
                            softmax_mode="clamped" if clamped else "online", **kw)
    rout, rlse = ff.flash_fwd_plain(*args)
    torch.cuda.synchronize()
    err, share = row_err(out, rout)
    lerr = float((lse - rlse).abs().max())
    ok = checks.check(f"{label} out", share, 1.0) & checks.check(f"{label} lse", lerr, 1e-3)
    line = (f"  {label}: max_abs_err {err:.3e} ({share:.3f} of its row's tol), lse err "
            f"{lerr:.3e} (tol 1e-3) {'ok' if ok else 'FAIL'}")
    del out, lse, rout, rlse
    times = None
    if timed:
        pairs = int(ff.live_pairs(masks, causal, Sq, Sk, "cuda").sum())
        pairs *= B if masks is None else 1
        flops = 4 * H * D * pairs
        ms = cuda_ms(torch, lambda: ff.flash_fwd_cuda(*args))
        plain_ms = cuda_ms(torch, lambda: ff.flash_fwd_plain(*args), iters=3, warmup=1)
        lib_ms = cuda_ms(torch, lib) if lib is not None else None
        nbytes = (q.numel() * 2 * 2 + k.numel() * 2 * 2 + B * H * Sq * 4
                  + (0 if masks is None else (Sq + Sk) * 8))
        b_ms, b_by = bound(nbytes, flops)
        times = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                     live_pairs=pairs)
        line += (f" | {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s on {pairs} live pairs), plain "
                 f"{plain_ms:.4f}, library (SDPA) "
                 + ("none" if lib_ms is None else f"{lib_ms:.4f}")
                 + f", bound {b_ms:.4f} ({b_by})")
        if graph:
            times["graph_ms"] = graph_ms(torch, lambda: ff.flash_fwd_cuda(*args))
            times["library_graph_ms"] = graph_ms(torch, lib)
            line += (f"; graph {times['graph_ms']:.4f}, library graph "
                     f"{times['library_graph_ms']:.4f} (ours / library "
                     f"{times['graph_ms'] / times['library_graph_ms']:.3f})")
    say(line)
    return err, times


def check_k4_gpt2(torch, checks, rows):
    """K4 at head_dim 64 (GPT-2 124M: H = Hk = 12, no rope), both softmax
    modes: causal at B=1 and B=8, S=1024 (the "K4 d64" row: B=1, clamped,
    BASELINE config 0's prefill, also from CUDA-graph replays beside
    SDPA's; B=8 under "also"), a shifted Sq=300
    Sk=1000, q rotated in the kernel at S=1024 (the kernel takes rope at 64;
    GPT-2 passes none); with segment ids and positions at phase 12's eight
    prompts packed in their bucket (the kernel's tile counts held to
    ``tile_test``'s), and with positions alone at a chunk of 256 at start
    512 over 1024 positions.  The timed points run beside SDPA on the same
    function (is_causal, or the boolean mask)."""
    import torch.nn.functional as F

    from flash_attn_tpu_torch.engine.scheduler import bucket_length
    from flash_attn_tpu_torch.ops import flash_fwd as ff
    from flash_attn_tpu_torch.ops.rope import rope_cos_sin

    g = torch.Generator(device="cuda").manual_seed(SEED + 51)
    H, D = GPT2_H, GPT2_D
    worst, times = 0.0, {}

    def qkv(B, Sq, Sk):
        return tuple(torch.randn((B, S, H, D), generator=g, device="cuda", dtype=torch.bfloat16)
                     for S in (Sq, Sk, Sk))

    for B, Sq, Sk in ((1, GPT2_S, GPT2_S), (8, GPT2_S, GPT2_S), (1, 300, 1000)):
        q, k, v = qkv(B, Sq, Sk)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        lib = None if Sq != Sk else (lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=True))
        for clamped in (True, False):
            label = (f"K4 D=64 {'clamped' if clamped else 'online'} B={B} Sq={Sq} Sk={Sk} "
                     f"H={H}")
            timed = clamped and Sq == Sk
            err, t = _k4_point(torch, checks, label, q, k, v, True, clamped, timed=timed, lib=lib,
                               graph=timed and B == 1)
            worst = max(worst, err)
            if t:
                times[B] = t
        del q, k, v, qt, kt, vt
    q, k, v = qkv(1, GPT2_S, GPT2_S)
    cos, sin = rope_cos_sin(torch.arange(GPT2_S, device="cuda")[None], D, 10000.0)
    err, _ = _k4_point(torch, checks, "K4 D=64 clamped B=1 S=1024, q rotated in the kernel", q, k,
                     v, True, True, cos=cos, sin=sin)
    worst = max(worst, err)
    # the masked instance: phase 12's prompts packed; a chunk over a cache
    lens, _ = _gpt2_prompts(50257)
    T = bucket_length(int(lens.sum()))
    seg, pos = (x.cuda() for x in _packed_positions(torch, [int(n) for n in lens], T))
    cpos = torch.arange(512, 768, device="cuda", dtype=torch.int32)[None]
    kpos = torch.arange(GPT2_S, device="cuda", dtype=torch.int32)[None]
    masked = {}
    for name, Sq, Sk, masks in (("packed", T, T, ff.Masks(seg, seg, pos, pos)),
                                ("chunk", 256, GPT2_S, ff.Masks(None, None, cpos, kpos))):
        q, k, v = qkv(1, Sq, Sk)
        live = ff.live_pairs(masks, False, Sq, Sk, "cuda")
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        label = f"K4 D=64 {name} Sq={Sq} Sk={Sk} H={H}"
        n_tiles, n_full, n_all = k4_tile_counts(torch, checks, label, q, k, v, None, None,
                                                False, masks)
        for clamped in (True, False):
            err, t = _k4_point(
                torch, checks, f"{label} {'clamped' if clamped else 'online'}", q, k, v, False,
                clamped, masks=masks, timed=clamped,
                lib=lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=live[:, None]))
            worst = max(worst, err)
            if t:
                masked[name] = dict(Sq=Sq, Sk=Sk, live_tiles=n_tiles, unmasked_tiles=n_full,
                                    **t)
        say(f"    {label}: K4 listed {n_tiles} of {n_all} tiles ({n_full} unmasked; the tile "
            f"test's counts alike)")
        del q, k, v, qt, kt, vt, live
    t1, t8 = times[1], times[8]
    rows["K4 d64"] = dict(
        name="flash_fwd (B=1, S=1024, H=Hk=12, D=64, causal, clamped: GPT-2 124M's prefill)",
        source="flash_attn_tpu_torch/csrc/flash_fwd.cu",
        replaces="flash_attn_tpu/ops/flash_fwd.py:221", max_abs_err=worst,
        **{key: t1[key] for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                                    "graph_ms", "library_graph_ms")},
        also=dict(label="B=8", **{key: t8[key] for key in ("ms", "plain_ms", "library_ms",
                                                           "bound_ms", "bound_by")}),
        **masked)


def _decode_case(torch, checks, dec, label, q, k, v, ks, vs, lens, T=1):
    """K1 (T=1) or K1c (T>1) at GPT-2's or Qwen-2's shapes through flash_decode /
    flash_decode_chunk against the plain version with the same splits, as
    check_k1 and check_k1c hold them.  Returns (max |err|, the plain
    version's args)."""
    B, Hk, S, D = k.shape
    H = q.shape[-2]
    G = H // Hk
    clamped, clamp2 = _mode_args(dec, k.dtype)
    if T == 1:
        nsplit, split_len = dec._splits(B, Hk, S, None)
        q2 = q
        got, glse = dec.flash_decode(q, k, v, k_scale=ks, v_scale=vs, kv_length=lens,
                                     return_lse=True, kv_layout="bhsd")
    else:
        nsplit, split_len = dec._chunk_splits(B, Hk, T * G, S, None), None
        q2 = q.reshape(B, T, Hk, G, D).transpose(1, 2).reshape(B, Hk * T * G, D).contiguous()
        got, glse = dec.flash_decode_chunk(q, k, v, k_scale=ks, v_scale=vs, kv_length=lens,
                                           return_lse=True)
    args = (q2, k, v, ks, vs, lens, D ** -0.5, clamped, clamp2, nsplit, split_len, T)
    ref2, rlse2 = plain_merge(*dec.flash_decode_plain(*args), torch.bfloat16)
    torch.cuda.synchronize()
    ref = ref2.reshape(B, Hk, T, G, D).transpose(1, 2).reshape(got.shape)
    rlse = rlse2.reshape(B, Hk, T, G).transpose(1, 2).reshape(glse.shape)
    err, share = row_err(got, ref)
    lerr = float((glse - rlse).abs().max())
    label = f"{label} ({'clamped' if clamped else 'online'}, {nsplit} splits)"
    ok = checks.check(f"{label} out", share, 1.0) & checks.check(f"{label} lse", lerr, 1e-3)
    say(f"  {label}: max_abs_err {err:.3e} ({share:.3f} of its row's tol), lse err {lerr:.3e} "
        f"(tol 1e-3) {'ok' if ok else 'FAIL'}")
    return err, args


def _decode_times(torch, dec, F, args, q, k, v, ks, vs, lens, T=1):
    """K1's or K1c's times at GPT-2's or Qwen-2's shapes: the kernel by events, the call
    as a user makes it (with K1m) as a CUDA graph, the plain version's,
    SDPA's on the dequantized cache and the bound."""
    B, Hk, S, D = k.shape
    H = q.shape[-2]
    kd, vd = _dequant(k, ks), _dequant(v, vs)
    limit = torch.clamp(lens.long()[:, None] - (T - 1)
                        + torch.arange(T, device="cuda")[None], max=S)  # [B, T]
    mask = (torch.arange(S, device="cuda")[None, None, :] < limit[:, :, None])[:, None]
    if T == 1:
        qt = q[:, :, None, :]
        call = lambda: dec.flash_decode(q, k, v, k_scale=ks, v_scale=vs,  # noqa: E731
                                        kv_length=lens, kv_layout="bhsd")
    else:
        qt = q.transpose(1, 2)
        call = lambda: dec.flash_decode_chunk(q, k, v, k_scale=ks,  # noqa: E731
                                              v_scale=vs, kv_length=lens)
    nbytes = k1_bytes(k, lens, ks) + 2 * q.numel() * 2 + lens.numel() * 4
    b_ms, b_by = bound(nbytes, 4 * H * D * int(limit.sum()))
    res = dict(ms=cuda_ms(torch, lambda: dec.flash_decode_cuda(*args)),
               call_graph_ms=graph_ms(torch, call),
               plain_ms=cuda_ms(torch, lambda: dec.flash_decode_plain(*args), iters=3),
               library_ms=cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                   qt, kd, vd, attn_mask=mask, enable_gqa=True)),
               bound_ms=b_ms, bound_by=b_by)
    del kd, vd
    return res


def _say_decode(label, t):
    say(f"    {label}: {t['ms']:.4f} ms (as called, graph {t['call_graph_ms']:.4f}), plain "
        f"{t['plain_ms']:.4f}, library (SDPA on the dequantized cache) {t['library_ms']:.4f}, "
        f"bound {t['bound_ms']:.4f} ({t['bound_by']})")


def check_decode_gpt2(torch, checks, rows):
    """The decode kernels at head_dim 64, GPT-2 124M's step (H = Hk = 12,
    capacity 1024): K1 at B=8 over bf16, int8 and fp8 caches and at B=1
    (BASELINE config 0), int8; K1m on K1's int8 partials at B=8 (bf16
    out, an idle slot); K1c (the verify step, T=5: 5 rows a KV head) at
    B=8, int8 and fp8, lengths with S, T and an idle slot's S + 7; one K8c
    point (T=128 at kv_len 640 over pages of 128, int8).  The int8 points
    carry the times of the "K1 d64", "K1m d64" and "K1c d64" rows (K2 at
    64: check_k2)."""
    import torch.nn.functional as F

    from flash_attn_tpu_torch.ops import decode as dec
    from flash_attn_tpu_torch.ops import paged_decode as pd

    g = torch.Generator(device="cuda").manual_seed(SEED + 52)
    H, D, S = GPT2_H, GPT2_D, GPT2_S
    shape = dict(H=H, Hk=H, S=S, D=D)
    worst = 0.0
    for kv, B in (("bf16", 8), ("int8", 8), ("fp8", 8), ("int8", 1)):
        q, k, v, ks, vs, lens = _decode_inputs(torch, kv, g, B=max(B, 2), **shape)
        if B == 1:  # the sequence at the full capacity
            q, k, v, ks, vs, lens = (None if x is None else x[:1].contiguous()
                                     for x in (q, k, v, ks, vs, lens))
        err, args = _decode_case(torch, checks, dec, f"K1 D=64 {kv} B={B}", q, k, v, ks,
                                     vs, lens)
        worst = max(worst, err)
        if kv == "int8":
            t = _decode_times(torch, dec, F, args[:11], q, k, v, ks, vs, lens)
            _say_decode(f"K1 D=64 int8 B={B}", t)
            if B == 8:
                rows["K1 d64"] = dict(
                    name="decode_bhsd (B=8, H=Hk=12, S=1024, D=64, int8 KV: GPT-2 124M)",
                    source="flash_attn_tpu_torch/csrc/decode.cu",
                    replaces="flash_attn_tpu/ops/decode.py:747", **t)
                # K1m on these partials, an idle slot among them
                lens[2] = 0
                outs, lses = dec.flash_decode_cuda(*args[:11])
                rows["K1m d64"] = _k1m_row(torch, checks, "B=8, H=12, D=64", outs, lses, idle=2)
                del outs, lses
            else:
                rows["K1 d64"]["also"] = dict(label="B=1 (BASELINE config 0)", **t)
        del q, k, v, ks, vs
    rows["K1 d64"]["max_abs_err"] = worst
    # K1c, the verify step: T=5 tokens, G=1
    T, B = 5, 8
    worst = 0.0
    for kv in ("int8", "fp8"):
        _, k, v, ks, vs, _ = _decode_inputs(torch, kv, g, B=B, **shape)
        q = torch.randn((B, T, H, D), generator=g, device="cuda", dtype=torch.bfloat16)
        lens = torch.randint(T, S + 1, (B,), generator=g, device="cuda", dtype=torch.int32)
        lens[0], lens[1], lens[2] = S, T, S + 7
        err, args = _decode_case(torch, checks, dec, f"K1c D=64 {kv} T={T} B={B}", q, k, v,
                                     ks, vs, lens, T=T)
        worst = max(worst, err)
        if kv == "int8":
            t = _decode_times(torch, dec, F, (*args[:10], None, T), q, k, v, ks, vs, lens,
                                  T=T)
            _say_decode(f"K1c D=64 int8 T={T}", t)
            rows["K1c d64"] = dict(
                name="decode_bhsd, chunk mode (B=8, T=5, H=Hk=12, S=1024, D=64, int8 KV: "
                     "GPT-2 124M's verify step)",
                source="flash_attn_tpu_torch/csrc/chunk_attn.cu",
                replaces="flash_attn_tpu/ops/decode.py:747", **t)
        del q, k, v, ks, vs
    # one K8c point: the chunk kernel over pages at head_dim 64
    _, k, v, ks, vs, table, _ = _paged_inputs(torch, "int8", g, 128, B=1, **shape)
    T, kv_len = 128, 640
    qc = torch.randn((1, T, H, D), generator=g, device="cuda", dtype=torch.bfloat16)
    lens = torch.tensor([kv_len], dtype=torch.int32, device="cuda")
    clamped, clamp2 = _mode_args(dec, k.dtype)
    nsplit = dec._chunk_splits(1, H, T, S, None)
    args = (qc.transpose(1, 2).reshape(1, H * T, D).contiguous(), k, v, ks, vs, table, lens,
            D ** -0.5, clamped, clamp2, T, nsplit, None)
    got, glse = pd.paged_flash_decode_chunk(qc, k, v, table, lens, k_scale=ks, v_scale=vs,
                                            return_lse=True)
    ref2, rlse2 = plain_merge(*pd.paged_flash_decode_plain(*args), torch.bfloat16)
    torch.cuda.synchronize()
    ref = ref2.reshape(1, H, T, D).transpose(1, 2)
    rlse = rlse2.reshape(1, H, T).transpose(1, 2)
    err, share = row_err(got, ref)
    lerr = float((glse - rlse).abs().max())
    label = f"K8c D=64 int8 T={T} kv_len={kv_len} ({nsplit} splits)"
    ok = checks.check(f"{label} out", share, 1.0) & checks.check(f"{label} lse", lerr, 1e-3)
    worst = max(worst, err)
    k8c_ms = cuda_ms(torch, lambda: pd.paged_flash_decode_cuda(*args))
    pairs = sum(kv_len - (T - 1) + t for t in range(T))
    kb_ms, kb_by = bound(2 * H * kv_len * (D + 4) + 2 * qc.numel() * 2 + glse.numel() * 4,
                         4 * H * D * pairs)
    say(f"  {label}: max_abs_err {err:.3e} ({share:.3f} of its row's tol), lse err {lerr:.3e} "
        f"(tol 1e-3) {'ok' if ok else 'FAIL'} | {k8c_ms:.4f} ms, bound {kb_ms:.4f} ({kb_by})")
    rows["K1c d64"]["k8c"] = dict(label=f"K8c T={T} kv_len={kv_len} page=128 int8", ms=k8c_ms,
                                  bound_ms=kb_ms, bound_by=kb_by)
    rows["K1c d64"]["max_abs_err"] = worst
    del k, v, ks, vs, qc


def check_k8_gpt2(torch, checks, rows):
    """K8 in decode mode at head_dim 64, GPT-2 124M's paged step: B=8,
    H = Hk = 12, pages of 128, 8 a sequence (1024 positions), bf16, int8
    and fp8 pages, as check_k8 holds it (``_k8_decode_case``); the int8
    point carries the "K8 d64" row's times."""
    import torch.nn.functional as F

    from flash_attn_tpu_torch.ops import paged_decode as pd

    g = torch.Generator(device="cuda").manual_seed(SEED + 53)
    worst = 0.0
    for kv in ("bf16", "int8", "fp8"):
        q, k, v, ks, vs, table, lens = _paged_inputs(torch, kv, g, 128, H=GPT2_H, Hk=GPT2_H,
                                                     S=GPT2_S, D=GPT2_D)
        err, args, nsplit, _ = _k8_decode_case(torch, checks, f"K8 D=64 decode {kv} page=128",
                                               q, k, v, ks, vs, table, lens)
        worst = max(worst, err)
        if kv == "int8":
            t = _k8_times(torch, pd, F, q, k, v, ks, vs, table, lens, args)
            t["plain_ms"] = cuda_ms(torch, lambda: pd.paged_flash_decode_plain(*args), iters=3)
            say(f"    K8 D=64 int8 page=128, lengths {lens.tolist()}: {t['ms']:.4f} ms (graph "
                f"{t['graph_ms']:.4f}; as called, graph {t['call_graph_ms']:.4f}), plain "
                f"{t['plain_ms']:.4f}, library (SDPA on the gathered, dequantized cache) "
                f"{t['library_ms']:.4f}, bound {t['bound_ms']:.4f} ({t['bound_by']})")
            rows["K8 d64"] = dict(
                name=f"paged_decode, decode mode (B=8, H=Hk=12, D=64, page=128, 8 pages/seq, "
                     f"int8 KV, {nsplit} live splits: GPT-2 124M)",
                source="flash_attn_tpu_torch/csrc/paged_decode.cu",
                replaces="flash_attn_tpu/ops/paged_decode.py:47", **t)
        del q, k, v, ks, vs
    rows["K8 d64"]["max_abs_err"] = worst


# --- Qwen-2-7B's shapes: 7 query heads a KV head (H=28, Hk=4, D=128) -------

QWEN_H, QWEN_HK, QWEN_THETA = 28, 4, 1000000.0
QWEN_GEMMS = ((3584, 3584), (3584, 512), (3584, 18944), (18944, 3584))


def check_qwen2(torch, checks, rows):
    """The attention kernels at Qwen-2-7B's 7 query heads a KV head, where a
    power-of-two assumption on the group would show (H=28, Hk=4, D=128),
    each against its plain version by the row rules above: K4 causal at
    B=1, S=2048, q rotated in the kernel, both softmax modes (clamped timed
    beside SDPA), and with segment ids and positions at phase 16's prompts
    packed in the 4096 bucket (its tile counts held to the tile test's); K1
    (7 rows in its 8-row tile) at B=8, S=4096, int8 and fp8; K1c at T=5 (35
    virtual rows in one 64-row warpgroup), int8 and fp8; K8 in decode mode
    (R=7) at pages of 128, int8 and fp8, also against K1 on the same
    content; K8c at T=128 over pages (896 rows), fp8.  The fp8 points carry
    the "K4 G7", "K1 G7", "K1c G7" and "K8 G7" rows' times (K2 at Hk=4:
    check_k2's "K2 G7").  Then K3 at Qwen-2-7B's widths, M = 8 and 512, its
    qkv bias at the wq and wk/wv widths (the K3 row's "qwen2" entry)."""
    import torch.nn.functional as F

    from flash_attn_tpu_torch.ops import decode as dec
    from flash_attn_tpu_torch.ops import flash_fwd as ff
    from flash_attn_tpu_torch.ops import paged_decode as pd
    from flash_attn_tpu_torch.ops.rope import rope_cos_sin, rope_rotate

    g = torch.Generator(device="cuda").manual_seed(SEED + 60)
    H, Hk, D, G = QWEN_H, QWEN_HK, 128, QWEN_H // QWEN_HK
    shape = dict(H=H, Hk=Hk, D=D)

    def qkv(Sq, Sk):
        return (torch.randn((1, Sq, H, D), generator=g, device="cuda", dtype=torch.bfloat16),
                *(torch.randn((1, Sk, Hk, D), generator=g, device="cuda",
                              dtype=torch.bfloat16) for _ in range(2)))

    # K4: causal with rope, then packed with segment ids and positions
    worst, times = 0.0, {}
    S = 2048
    q, k, v = qkv(S, S)
    cos, sin = rope_cos_sin(torch.arange(S, device="cuda")[None], D, QWEN_THETA)
    qr = rope_rotate(q, cos, sin).transpose(1, 2).contiguous()
    kt, vt = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    for clamped in (True, False):
        err, t = _k4_point(
            torch, checks, f"K4 G=7 {'clamped' if clamped else 'online'} S={S} H={H} Hk={Hk}",
            q, k, v, True, clamped, cos=cos, sin=sin, timed=clamped,
            lib=lambda: F.scaled_dot_product_attention(qr, kt, vt, is_causal=True,
                                                       enable_gqa=True))
        worst = max(worst, err)
        times[clamped] = t
    del q, k, v, qr, kt, vt
    lens, _ = _prompts(152064)
    seg, pos = (x.cuda() for x in _packed_positions(torch, [int(n) for n in lens], PACKED_M))
    masks = ff.Masks(seg, seg, pos, pos)
    q, k, v = qkv(PACKED_M, PACKED_M)
    cos, sin = rope_cos_sin(pos, D, QWEN_THETA)
    live = ff.live_pairs(masks, False, PACKED_M, PACKED_M, "cuda")
    qr = rope_rotate(q, cos, sin).transpose(1, 2).contiguous()
    kt, vt = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    label = f"K4 G=7 packed Sq=Sk={PACKED_M} H={H} Hk={Hk}"
    n_tiles, n_full, n_all = k4_tile_counts(torch, checks, label, q, k, v, cos, sin, False,
                                            masks)
    for clamped in (True, False):
        err, t = _k4_point(
            torch, checks, f"{label} {'clamped' if clamped else 'online'}", q, k, v, False,
            clamped, masks=masks, cos=cos, sin=sin, timed=clamped,
            lib=lambda: F.scaled_dot_product_attention(qr, kt, vt, attn_mask=live[:, None],
                                                       enable_gqa=True))
        worst = max(worst, err)
        if t:
            packed = dict(Sq=PACKED_M, Sk=PACKED_M, live_tiles=n_tiles, unmasked_tiles=n_full,
                          **t)
    say(f"    {label}: K4 listed {n_tiles} of {n_all} tiles ({n_full} unmasked; the tile "
        f"test's counts alike)")
    del q, k, v, qr, kt, vt, live
    t = times[True]
    rows["K4 G7"] = dict(
        name=f"flash_fwd (B=1, S={S}, H={H}, Hk={Hk}, D=128, causal, rope, clamped: Qwen-2-7B)",
        source="flash_attn_tpu_torch/csrc/flash_fwd.cu",
        replaces="flash_attn_tpu/ops/flash_fwd.py:221", max_abs_err=worst, packed=packed,
        **{key: t[key] for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")})

    # K1 (T=1) and K1c (T=5), int8 and fp8, B=8 over 4096 positions
    for T, key, source in ((1, "K1 G7", "decode.cu"), (5, "K1c G7", "chunk_attn.cu")):
        worst = 0.0
        for kv in ("int8", "fp8"):
            _, k, v, ks, vs, lens = _decode_inputs(torch, kv, g, B=8, S=4096, **shape)
            if T == 1:
                q = torch.randn((8, H, D), generator=g, device="cuda", dtype=torch.bfloat16)
            else:
                q = torch.randn((8, T, H, D), generator=g, device="cuda", dtype=torch.bfloat16)
                lens = torch.randint(T, 4097, (8,), generator=g, device="cuda",
                                     dtype=torch.int32)
                lens[0], lens[1], lens[2] = 4096, T, 4096 + 7
            name = f"K1 G=7 {kv} B=8" if T == 1 else f"K1c G=7 {kv} T={T} B=8"
            err, args = _decode_case(torch, checks, dec, name, q, k, v, ks, vs, lens, T=T)
            worst = max(worst, err)
            if kv == "fp8":
                targs = args[:11] if T == 1 else (*args[:10], None, T)
                t = _decode_times(torch, dec, F, targs, q, k, v, ks, vs, lens, T=T)
                _say_decode(name, t)
                what = ("decode_bhsd" if T == 1 else f"decode_bhsd, chunk mode (T={T}, "
                        f"{T * G} virtual rows a KV head)")
                rows[key] = dict(
                    name=f"{what} (B=8, H={H}, Hk={Hk}, S=4096, D=128, fp8 KV: Qwen-2-7B)",
                    source=f"flash_attn_tpu_torch/csrc/{source}",
                    replaces="flash_attn_tpu/ops/decode.py:747", **t)
            del q, k, v, ks, vs
        rows[key]["max_abs_err"] = worst

    # K8 in decode mode (R=7), then K8c at T=128 (896 rows)
    worst = 0.0
    for kv in ("int8", "fp8"):
        q, k, v, ks, vs, table, lens = _paged_inputs(torch, kv, g, 128, **shape)
        err, args, nsplit, _ = _k8_decode_case(torch, checks, f"K8 G=7 decode {kv} page=128",
                                               q, k, v, ks, vs, table, lens)
        worst = max(worst, err)
        if kv == "fp8":
            t = _k8_times(torch, pd, F, q, k, v, ks, vs, table, lens, args)
            t["plain_ms"] = cuda_ms(torch, lambda: pd.paged_flash_decode_plain(*args), iters=3)
            say(f"    K8 G=7 fp8 page=128, lengths {lens.tolist()}: {t['ms']:.4f} ms (graph "
                f"{t['graph_ms']:.4f}; as called, graph {t['call_graph_ms']:.4f}), plain "
                f"{t['plain_ms']:.4f}, library (SDPA on the gathered, dequantized cache) "
                f"{t['library_ms']:.4f}, bound {t['bound_ms']:.4f} ({t['bound_by']})")
            rows["K8 G7"] = dict(
                name=f"paged_decode, decode mode (B=8, H={H}, Hk={Hk}, D=128, page=128, 32 "
                     f"pages/seq, fp8 KV, {nsplit} live splits: Qwen-2-7B)",
                source="flash_attn_tpu_torch/csrc/paged_decode.cu",
                replaces="flash_attn_tpu/ops/paged_decode.py:47", **t)
        del q, k, v, ks, vs
    _, k, v, ks, vs, table, _ = _paged_inputs(torch, "fp8", g, 128, B=1, **shape)
    T, kv_len = 128, 640
    qc = torch.randn((1, T, H, D), generator=g, device="cuda", dtype=torch.bfloat16)
    lens = torch.tensor([kv_len], dtype=torch.int32, device="cuda")
    clamped, clamp2 = _mode_args(dec, k.dtype)
    nsplit = dec._chunk_splits(1, Hk, T * G, 4096, None)
    q2 = qc.reshape(1, T, Hk, G, D).transpose(1, 2).reshape(1, Hk * T * G, D).contiguous()
    args = (q2, k, v, ks, vs, table, lens, D ** -0.5, clamped, clamp2, T, nsplit, None)
    got, glse = pd.paged_flash_decode_chunk(qc, k, v, table, lens, k_scale=ks, v_scale=vs,
                                            return_lse=True)
    ref2, rlse2 = plain_merge(*pd.paged_flash_decode_plain(*args), torch.bfloat16)
    torch.cuda.synchronize()
    ref = ref2.reshape(1, Hk, T, G, D).transpose(1, 2).reshape(1, T, H, D)
    rlse = rlse2.reshape(1, Hk, T, G).transpose(1, 2).reshape(1, T, H)
    err, share = row_err(got, ref)
    lerr = float((glse - rlse).abs().max())
    label = f"K8c G=7 fp8 T={T} kv_len={kv_len} ({nsplit} splits)"
    ok = checks.check(f"{label} out", share, 1.0) & checks.check(f"{label} lse", lerr, 1e-3)
    worst = max(worst, err)
    k8c_ms = cuda_ms(torch, lambda: pd.paged_flash_decode_cuda(*args))
    pairs = sum(kv_len - (T - 1) + t for t in range(T))
    kb_ms, kb_by = bound(2 * Hk * kv_len * (D + 4) + 2 * qc.numel() * 2 + glse.numel() * 4,
                         4 * H * D * pairs)
    say(f"  {label}: max_abs_err {err:.3e} ({share:.3f} of its row's tol), lse err {lerr:.3e} "
        f"(tol 1e-3) {'ok' if ok else 'FAIL'} | {k8c_ms:.4f} ms, bound {kb_ms:.4f} ({kb_by})")
    rows["K8 G7"]["k8c"] = dict(label=f"K8c T={T} kv_len={kv_len} page=128 fp8", ms=k8c_ms,
                                bound_ms=kb_ms, bound_by=kb_by)
    rows["K8 G7"]["max_abs_err"] = worst
    del k, v, ks, vs, qc
    check_k3_gemma(torch, checks, rows, QWEN_GEMMS, "qwen2", "Qwen-2-7B", SEED + 61,
                   ms=(8, 512), biased=QWEN_GEMMS[:2])


# --- Mistral-7B's attention widths with its 4096-token window (H=32, -------
# --- Hk=8, D=128): K4's masked kLocal instance, K1c, K8 and K8c ------------

MISTRAL_WINDOW = 4096
# phase 2's packed prefill: 8 prompts in one 8192-token row, the first past
# the window
MISTRAL_PACKED = (4600, 1200, 800, 600, 400, 300, 200, 92)


def mistral_7b():
    """Mistral-7B-v0.1's published config (``mistralai/Mistral-7B-v0.1``,
    ``config.json``): Llama's layout, 32 layers, hidden 4096, intermediate
    14336, 32 query heads over 8 KV heads of 128, vocab 32000, rope_theta
    1e4, rms_norm_eps 1e-5, max_position_embeddings 32768,
    sliding_window 4096, untied embeddings."""
    from flash_attn_tpu_torch.models import llama

    return llama.LlamaConfig(vocab_size=32000, hidden=4096, intermediate=14336, num_layers=32,
                             num_heads=32, num_kv_heads=8, head_dim=128, rope_theta=10000.0,
                             rms_eps=1e-5, max_position=32768, sliding_window=MISTRAL_WINDOW)


def _window_mask(torch, lens, T, S, window):
    """[B, 1, T, S] bool: chunk row t of a sequence of length ``lens[b]``
    (the chunk included) sees positions [limit - window, limit), limit =
    len - (T - 1) + t, as the decode kernels' plain versions mask them.
    Returns (mask, live pairs summed over the batch and rows)."""
    limit = lens.long()[:, None] - (T - 1) + torch.arange(T, device="cuda")[None]  # [B, T]
    pos = torch.arange(S, device="cuda")[None, None, :]
    mask = (pos < limit[:, :, None]) & (pos >= limit[:, :, None] - window)
    return mask[:, None], int(mask.sum())


def _window_rows(torch, lens, T, S, window):
    """K/V positions a windowed chunk walk must read per sequence: [max(0,
    len - (T - 1) - window), min(len, S))."""
    lo = torch.clamp(lens.long() - (T - 1) - window, min=0)
    return torch.clamp(torch.clamp(lens.long(), max=S) - lo, min=0)


def check_mistral(torch, checks, rows):
    """The kernels that carry a sliding window on the serving paths, at
    Mistral-7B's attention widths (H=32, Hk=8, D=128, window 4096), each
    against its plain version by the row rules above:
    K4's masked kLocal instance with segment ids and positions, the
    window (4095, -1) on the positions: 8 prompts packed into 8192 tokens
    (``MISTRAL_PACKED``), clamped, q rotated in the kernel (the "K4 local
    seg" row, timed beside SDPA with the window as a boolean mask), again
    with cap 50 (no single PyTorch call applies the cap) and online, and
    a chunk of 512 at positions 6000-6511 over an 8192-position cache (the
    chunked prefill), each with its tile counts held to the tile test's;
    K1c at B=8, T=5 over a contiguous S=8192 cache, fp8 and int8, lengths
    to 8000 with 4096, 4097 and an idle slot's S + 7 (the "K1c window"
    row); K8 in decode mode at pages of 128, lengths to 8000, fp8 and
    int8, also against K1's windowed decode on the same content (the "K8
    window" row); K8c at T=128 over pages, kv_len 8000 and 4200 (the "K8c
    window" row).  Bounds count only the live pairs and the K/V rows inside
    the window."""
    import torch.nn.functional as F

    from flash_attn_tpu_torch.ops import decode as dec
    from flash_attn_tpu_torch.ops import flash_fwd as ff
    from flash_attn_tpu_torch.ops import paged_decode as pd
    from flash_attn_tpu_torch.ops.rope import rope_cos_sin, rope_rotate

    g = torch.Generator(device="cuda").manual_seed(SEED + 90)
    H, Hk, D, W = 32, 8, 128, MISTRAL_WINDOW
    G = H // Hk
    window = (W - 1, -1)

    # K4 with segment ids, positions and the window
    S = sum(MISTRAL_PACKED)
    seg, pos = (x.cuda() for x in _packed_positions(torch, MISTRAL_PACKED, S))
    masks = ff.Masks(seg, seg, pos, pos)
    q = torch.randn((1, S, H, D), generator=g, device="cuda", dtype=torch.bfloat16)
    k, v = (torch.randn((1, S, Hk, D), generator=g, device="cuda", dtype=torch.bfloat16)
            for _ in range(2))
    cos, sin = rope_cos_sin(pos, D, 10000.0)
    live = ff.live_pairs(masks, False, S, S, "cuda", window)
    qr = rope_rotate(q, cos, sin).transpose(1, 2).contiguous()
    kt, vt = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    pairs = int(live.sum())
    nbytes = (q.numel() + k.numel()) * 2 * 2 + H * S * 4 + 2 * S * 8
    b_ms, b_by = bound(nbytes, 4 * H * D * pairs)
    worst, res = 0.0, {}
    for name, clamped, cap in (("window", True, None), ("window, cap 50", True, GEMMA_CAP),
                               ("window, online", False, None)):
        args = (q, k, v, False, D ** -0.5, cos, sin, clamped, masks, window, cap)
        out, lse = ff.flash_fwd(q, k, v, rope_cos=cos, rope_sin=sin, window=window,
                                logit_softcap=cap,
                                softmax_mode="clamped" if clamped else "online",
                                **masks._asdict())
        rout, rlse = fwd_plain(args)
        torch.cuda.synchronize()
        err, share = row_err(out, rout)
        lerr = float((lse - rlse).abs().max())
        label = f"K4 local seg, {name}, {len(MISTRAL_PACKED)} prompts packed in {S}"
        ok = checks.check(f"{label} out", share, 1.0) & checks.check(f"{label} lse", lerr, 1e-3)
        worst = max(worst, err)
        del out, lse, rout, rlse
        line = (f"  {label}: max_abs_err {err:.3e} ({share:.3f} of its row's tol), lse err "
                f"{lerr:.3e} (tol 1e-3) {'ok' if ok else 'FAIL'}")
        if clamped:
            t = dict(ms=cuda_ms(torch, lambda: ff.flash_fwd_cuda(*args)),
                     plain_ms=cuda_ms(torch, lambda: fwd_plain(args), iters=3, warmup=1),
                     library_ms=None if cap else cuda_ms(
                         torch, lambda: F.scaled_dot_product_attention(
                             qr, kt, vt, attn_mask=live[:, None], enable_gqa=True)),
                     bound_ms=b_ms, bound_by=b_by, live_pairs=pairs)
            res[name] = t
            line += (f" | {t['ms']:.4f} ms ({4 * H * D * pairs / t['ms'] / 1e9:.1f} TFLOP/s on "
                     f"{pairs} live pairs), plain {t['plain_ms']:.4f}, library "
                     + ("none (no single PyTorch call applies the cap)" if cap else
                        f"(SDPA, the window as a boolean mask) {t['library_ms']:.4f}")
                     + f", bound {b_ms:.4f} ({b_by})")
        say(line)
    n_tiles, n_full, n_all = k4_tile_counts(torch, checks, "K4 local seg packed", q, k, v, cos,
                                            sin, False, masks, window)
    say(f"    K4 local seg packed: listed {n_tiles} of {n_all} tiles ({n_full} unmasked; the "
        f"tile test's counts alike)")
    del q, k, v, qr, kt, vt, live
    # the chunked prefill's form: a chunk at positions start.. over the cache
    Sq, Sk, start = 512, 8192, 6000
    qpos = (start + torch.arange(Sq, device="cuda", dtype=torch.int32))[None]
    kpos = torch.arange(Sk, device="cuda", dtype=torch.int32)[None]
    cmasks = ff.Masks(None, None, qpos, kpos)
    q = torch.randn((1, Sq, H, D), generator=g, device="cuda", dtype=torch.bfloat16)
    k, v = (torch.randn((1, Sk, Hk, D), generator=g, device="cuda", dtype=torch.bfloat16)
            for _ in range(2))
    cos, sin = rope_cos_sin(qpos, D, 10000.0)
    args = (q, k, v, False, D ** -0.5, cos, sin, True, cmasks, window, None)
    out, lse = ff.flash_fwd(q, k, v, rope_cos=cos, rope_sin=sin, window=window,
                            softmax_mode="clamped", **cmasks._asdict())
    rout, rlse = fwd_plain(args)
    torch.cuda.synchronize()
    err, share = row_err(out, rout)
    lerr = float((lse - rlse).abs().max())
    label = f"K4 local seg, chunk Sq={Sq} at {start} over Sk={Sk}"
    ok = checks.check(f"{label} out", share, 1.0) & checks.check(f"{label} lse", lerr, 1e-3)
    worst = max(worst, err)
    c_tiles, c_full, c_all = k4_tile_counts(torch, checks, label, q, k, v, cos, sin, False,
                                            cmasks, window)
    cpairs = int(ff.live_pairs(cmasks, False, Sq, Sk, "cuda", window).sum())
    cb_ms, cb_by = bound((q.numel() + k.numel()) * 2 * 2 + H * Sq * 4 + (Sq + Sk) * 8,
                         4 * H * D * cpairs)
    chunk = dict(ms=cuda_ms(torch, lambda: ff.flash_fwd_cuda(*args)), bound_ms=cb_ms,
                 bound_by=cb_by, live_tiles=c_tiles, unmasked_tiles=c_full)
    say(f"  {label}: max_abs_err {err:.3e} ({share:.3f} of its row's tol), lse err {lerr:.3e} "
        f"(tol 1e-3) {'ok' if ok else 'FAIL'} | {chunk['ms']:.4f} ms, bound {cb_ms:.4f} "
        f"({cb_by}); listed {c_tiles} of {c_all} tiles ({c_full} unmasked)")
    del q, k, v, out, lse, rout, rlse
    rows["K4 local seg"] = dict(
        name=f"flash_fwd masked kLocal (B=1, {len(MISTRAL_PACKED)} prompts packed in {S}, "
             f"H={H}, Hk={Hk}, D=128, segment ids and positions, window (4095, -1) on the "
             f"positions, rope, clamped: Mistral-7B)",
        source="flash_attn_tpu_torch/csrc/flash_fwd.cu",
        replaces="flash_attn_tpu/ops/flash_fwd.py:221", max_abs_err=worst,
        softcap=dict(label="cap 50", **res["window, cap 50"]), chunk=chunk,
        **{key: res["window"][key] for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                                                "bound_by")})

    # K1c: T=5 over a contiguous cache of 8192
    B, T, S = 8, 5, 8192
    worst = 0.0
    for kv in ("int8", "fp8"):
        _, k, v, ks, vs, _ = _decode_inputs(torch, kv, g, B=B, S=S, H=H, Hk=Hk)
        q = torch.randn((B, T, H, D), generator=g, device="cuda", dtype=torch.bfloat16)
        lens = torch.randint(T, 8001, (B,), generator=g, device="cuda", dtype=torch.int32)
        lens[:4] = torch.tensor([8000, 4096, 4097, S + 7], dtype=torch.int32)
        clamped, clamp2 = _mode_args(dec, k.dtype)
        nsplit = dec._chunk_splits(B, Hk, T * G, min(S, W + T - 1 + dec.TILE), None)
        q2 = q.reshape(B, T, Hk, G, D).transpose(1, 2).reshape(B, Hk * T * G, D).contiguous()
        args = (q2, k, v, ks, vs, lens, D ** -0.5, clamped, clamp2, nsplit, None, T, "bhsd", W)
        got, glse = dec.flash_decode_chunk(q, k, v, k_scale=ks, v_scale=vs, kv_length=lens,
                                           window=W, return_lse=True)
        ref2, rlse2 = plain_merge(*dec.flash_decode_plain(*args), torch.bfloat16)
        torch.cuda.synchronize()
        ref = ref2.reshape(B, Hk, T, G, D).transpose(1, 2).reshape(got.shape)
        rlse = rlse2.reshape(B, Hk, T, G).transpose(1, 2).reshape(glse.shape)
        err, share = row_err(got, ref)
        lerr = float((glse - rlse).abs().max())
        label = f"K1c window {kv} B={B} T={T} S={S} ({nsplit} splits)"
        ok = checks.check(f"{label} out", share, 1.0) & checks.check(f"{label} lse", lerr, 1e-3)
        worst = max(worst, err)
        say(f"  {label}: max_abs_err {err:.3e} ({share:.3f} of its row's tol), lse err "
            f"{lerr:.3e} (tol 1e-3) {'ok' if ok else 'FAIL'}")
        if kv == "fp8":
            kd, vd = _dequant(k, ks), _dequant(v, vs)
            mask, pairs = _window_mask(torch, lens, T, S, W)
            nbytes = (2 * Hk * int(_window_rows(torch, lens, T, S, W).sum()) * (D + 4)
                      + 2 * q.numel() * 2 + lens.numel() * 4)
            t = _chunk_times(
                torch, lambda: dec.flash_decode_cuda(*args),
                lambda: dec.flash_decode_chunk(q, k, v, k_scale=ks, v_scale=vs, kv_length=lens,
                                               window=W),
                lambda: F.scaled_dot_product_attention(q.transpose(1, 2), kd, vd,
                                                       attn_mask=mask, enable_gqa=True),
                nbytes, 4 * H * D * pairs)
            t["plain_ms"] = cuda_ms(torch, lambda: dec.flash_decode_plain(*args), iters=3)
            _say_times(f"K1c window fp8, lengths {lens.tolist()}", t)
            say(f"    plain {t['plain_ms']:.4f}")
            rows["K1c window"] = dict(
                name=f"decode_bhsd, chunk mode, window {W} (B={B}, T={T}, H={H}, Hk={Hk}, "
                     f"S={S}, D=128, fp8 KV, {nsplit} splits of the windowed walk: Mistral-7B)",
                source="flash_attn_tpu_torch/csrc/chunk_attn.cu",
                replaces="flash_attn_tpu/ops/decode.py:747", **t)
            del kd, vd, mask
        del q, k, v, ks, vs
    rows["K1c window"]["max_abs_err"] = worst

    # K8 in decode mode, then K8c at T=128, pages of 128 over 8192 positions
    worst = 0.0
    for kv in ("int8", "fp8"):
        q, k, v, ks, vs, table, lens = _paged_inputs(torch, kv, g, 128, B=B, H=H, Hk=Hk, S=S)
        lens[4:] = torch.tensor([8000, 4096, 4097, 6000], dtype=torch.int32)
        err, args, nsplit, _ = _k8_decode_case(torch, checks, f"K8 window {kv} page=128", q, k,
                                               v, ks, vs, table, lens, window=W)
        worst = max(worst, err)
        if kv == "fp8":
            t = _k8_times(torch, pd, F, q, k, v, ks, vs, table, lens, args, window=W)
            t["plain_ms"] = cuda_ms(torch, lambda: pd.paged_flash_decode_plain(*args), iters=3)
            say(f"    K8 window fp8 page=128, lengths {lens.tolist()}: {t['ms']:.4f} ms (graph "
                f"{t['graph_ms']:.4f}; as called, graph {t['call_graph_ms']:.4f}), plain "
                f"{t['plain_ms']:.4f}, library (SDPA on the gathered, dequantized cache, the "
                f"window as a boolean mask) {t['library_ms']:.4f}, bound {t['bound_ms']:.4f} "
                f"({t['bound_by']})")
            rows["K8 window"] = dict(
                name=f"paged_decode, decode mode, window {W} (B={B}, H={H}, Hk={Hk}, D=128, "
                     f"page=128, 64 pages/seq, fp8 KV, {nsplit} splits of the windowed walk: "
                     f"Mistral-7B)",
                source="flash_attn_tpu_torch/csrc/paged_decode.cu",
                replaces="flash_attn_tpu/ops/paged_decode.py:47", **t)
        del q, k, v, ks, vs
    rows["K8 window"]["max_abs_err"] = worst
    worst = 0.0
    _, k, v, ks, vs, table, _ = _paged_inputs(torch, "fp8", g, 128, B=1, H=H, Hk=Hk, S=S)
    T = 128
    clamped, clamp2 = _mode_args(dec, k.dtype)
    nsplit = pd._plan(1, Hk, T * G, T, S, None, W)[0]
    for kv_len in (8000, 4200):
        qc = torch.randn((1, T, H, D), generator=g, device="cuda", dtype=torch.bfloat16)
        lens = torch.tensor([kv_len], dtype=torch.int32, device="cuda")
        q2 = qc.reshape(1, T, Hk, G, D).transpose(1, 2).reshape(1, Hk * T * G, D).contiguous()
        args = (q2, k, v, ks, vs, table, lens, D ** -0.5, clamped, clamp2, T, nsplit, None, W)
        got, glse = pd.paged_flash_decode_chunk(qc, k, v, table, lens, k_scale=ks, v_scale=vs,
                                                window=W, return_lse=True)
        ref2, rlse2 = plain_merge(*pd.paged_flash_decode_plain(*args), torch.bfloat16)
        torch.cuda.synchronize()
        ref = ref2.reshape(1, Hk, T, G, D).transpose(1, 2).reshape(1, T, H, D)
        rlse = rlse2.reshape(1, Hk, T, G).transpose(1, 2).reshape(1, T, H)
        err, share = row_err(got, ref)
        lerr = float((glse - rlse).abs().max())
        label = f"K8c window fp8 T={T} kv_len={kv_len} ({nsplit} splits)"
        ok = checks.check(f"{label} out", share, 1.0) & checks.check(f"{label} lse", lerr, 1e-3)
        worst = max(worst, err)
        line = (f"  {label}: max_abs_err {err:.3e} ({share:.3f} of its row's tol), lse err "
                f"{lerr:.3e} (tol 1e-3) {'ok' if ok else 'FAIL'}")
        if kv_len == 8000:
            kc, vc = pd._gather(k, table), pd._gather(v, table)
            kd = _dequant(kc, pd._gather(ks, table))
            vd = _dequant(vc, pd._gather(vs, table))
            mask, pairs = _window_mask(torch, lens, T, S, W)
            nbytes = (2 * Hk * int(_window_rows(torch, lens, T, S, W).sum()) * (D + 4)
                      + 2 * qc.numel() * 2 + glse.numel() * 4)
            b_ms, b_by = bound(nbytes, 4 * H * D * pairs)
            t = dict(ms=cuda_ms(torch, lambda: pd.paged_flash_decode_cuda(*args)),
                     call_graph_ms=graph_ms(torch, lambda: pd.paged_flash_decode_chunk(
                         qc, k, v, table, lens, k_scale=ks, v_scale=vs, window=W)),
                     plain_ms=cuda_ms(torch, lambda: pd.paged_flash_decode_plain(*args),
                                      iters=3),
                     library_ms=cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                         qc.transpose(1, 2), kd, vd, attn_mask=mask, enable_gqa=True)),
                     bound_ms=b_ms, bound_by=b_by)
            line += (f" | {t['ms']:.4f} ms (as called, graph {t['call_graph_ms']:.4f}), plain "
                     f"{t['plain_ms']:.4f}, library (SDPA on the gathered, dequantized cache, "
                     f"the window as a boolean mask) {t['library_ms']:.4f}, bound "
                     f"{b_ms:.4f} ({b_by})")
            rows["K8c window"] = dict(
                name=f"paged_decode, chunk mode, window {W} (B=1, T={T}, H={H}, Hk={Hk}, "
                     f"D=128, page=128, kv_len {kv_len}, fp8 KV, {nsplit} splits: the "
                     f"prefix-hit suffix prefill, Mistral-7B)",
                source="flash_attn_tpu_torch/csrc/chunk_attn.cu",
                replaces="flash_attn_tpu/ops/paged_decode.py:47", **t)
            del kc, vc, kd, vd, mask
        say(line)
    rows["K8c window"]["max_abs_err"] = worst
    del k, v, ks, vs


# phase 26's row: Mistral-7B trained on four documents packed in 8192 tokens,
# the first past the 4096-token window
MISTRAL_TRAIN_DOCS = (4800, 2000, 900, 492)
MISTRAL_TRAIN_SEQ = 8192


def check_mistral_train(torch, checks, rows):
    """The kernels of Mistral-7B's training on packed documents, at its
    attention widths (H=32, Hk=8, D=128, window (4095, -1)), B=1, the
    documents MISTRAL_TRAIN_DOCS in one 8192-token row (segment ids 1-4,
    RoPE on the positions restarting a document, causal, online), as
    ``llama.forward(segment_ids=...)`` calls them: segment ids alone, so
    the window compares the indices.  K4's masked kLocal instance's twin
    on the indices (the "K4 local seg idx" row) against its plain version
    by the row rule, timed beside SDPA with the segment-and-window mask as
    a boolean mask; K9's and K10's kLocal and kOpt instances' twin (the
    rows "K9 local seg" and "K10 local seg") through _bwd_case (each
    launched twice, bitwise; the rows of a document's first query, one
    live key, at the noise floor), timed beside SDPA's backward with the
    same boolean mask (device time); then, checked only, the same row with
    positions given (the window on the positions: the instances without
    the twin), and with cap 5 on the indices (the cap bends: a kernel
    without its 1 - t^2 factor fails).  Bounds: ops on the live pairs (K4
    two products, K9 three, K10 four)."""
    import torch.nn.functional as F

    from flash_attn_tpu_torch.ops import flash_bwd as fb
    from flash_attn_tpu_torch.ops import flash_fwd as ff
    from flash_attn_tpu_torch.ops.rope import rope_cos_sin, rope_rotate

    g = torch.Generator(device="cuda").manual_seed(SEED + 95)
    H, Hk, D, S = 32, 8, 128, MISTRAL_TRAIN_SEQ
    window, scale = (MISTRAL_WINDOW - 1, -1), D ** -0.5
    seg, pos = (x.cuda() for x in _packed_positions(torch, MISTRAL_TRAIN_DOCS, S))
    masks = ff.Masks(seg, seg, None, None)

    def rnd(h):
        return torch.randn((1, S, h, D), generator=g, device="cuda", dtype=torch.bfloat16)

    q, k, v, dout = rnd(H), rnd(Hk), rnd(Hk), rnd(H)
    cos, sin = rope_cos_sin(pos, D, 10000.0)
    live = ff.live_pairs(masks, True, S, S, "cuda", window)
    pairs = int(live.sum())
    gemm = 2 * D * H * pairs  # one product over the live pairs
    qr = rope_rotate(q, cos, sin).transpose(1, 2).contiguous()
    kt, vt = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()

    # K4, the window on the indices
    args = (q, k, v, True, scale, cos, sin, False, masks, window, None)
    out, lse = ff.flash_fwd_cuda(*args)
    rout, rlse = fwd_plain(args)
    torch.cuda.synchronize()
    err, share = row_err(out, rout)
    lerr = float((lse - rlse).abs().max())
    label = (f"K4 local seg idx, documents {MISTRAL_TRAIN_DOCS} in {S}, segment ids alone, "
             f"window {window} on the indices, causal, online")
    ok = checks.check(f"{label} out", share, 1.0) & checks.check(f"{label} lse", lerr, 1e-3)
    del rout, rlse
    nbytes = (q.numel() + k.numel()) * 2 * 2 + H * S * 4 + 2 * S * 8
    b_ms, b_by = bound(nbytes, 2 * gemm)
    t4 = dict(ms=cuda_ms(torch, lambda: ff.flash_fwd_cuda(*args)),
              plain_ms=cuda_ms(torch, lambda: fwd_plain(args), iters=2, warmup=1),
              library_ms=cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                  qr, kt, vt, attn_mask=live[:, None], enable_gqa=True), iters=5),
              bound_ms=b_ms, bound_by=b_by, live_pairs=pairs)
    say(f"  {label}: max_abs_err {err:.3e} ({share:.3f} of its row's tol), lse err {lerr:.3e} "
        f"(tol 1e-3) {'ok' if ok else 'FAIL'} | {t4['ms']:.4f} ms ({2 * gemm / t4['ms'] / 1e9:.1f}"
        f" TFLOP/s on {pairs} live pairs), plain {t4['plain_ms']:.4f}, library (SDPA, the "
        f"segments and the window as a boolean mask) {t4['library_ms']:.4f}, bound "
        f"{b_ms:.4f} ({b_by})")
    rows["K4 local seg idx"] = dict(
        name=f"flash_fwd masked kLocal, the window on the indices (B=1, documents "
             f"{MISTRAL_TRAIN_DOCS} in {S}, H={H}, Hk={Hk}, D=128, segment ids alone, window "
             f"{window}, causal, rope, online: Mistral-7B's training forward)",
        source="flash_attn_tpu_torch/csrc/flash_fwd.cu",
        replaces="flash_attn_tpu/ops/flash_fwd.py:221", max_abs_err=err, **t4)

    # K9 and K10 on K4's out and lse
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    del out
    worst = {"K9": 0.0, "K10": 0.0}
    counts = live.sum(-1)[..., None].expand(-1, -1, H)

    def floor(rdq):
        return torch.where(counts < 2, 2.0 ** -12 * float(rdq.abs().max()), 1e-6)

    args = (q, k, v, dout, lse, delta, True, scale, cos, sin, window, None, masks)
    tail = (k, v, dout, lse, delta, True, scale, window, None, masks)
    label = (f"local seg, documents {MISTRAL_TRAIN_DOCS} in {S}, segment ids alone, window "
             f"{window} on the indices, causal, rope")
    dq, rq, dk, dv, res = _bwd_case(torch, checks, worst, label, args, tail, True, floor)
    say(f"  K9 {label}: {res['K9']}")
    say(f"  K10 {label}: {res['K10']}")
    del dq, dk, dv
    kargs = (rq, *tail)
    ms9 = cuda_ms(torch, lambda: fb.flash_bwd_dq_cuda(*args))
    ms10 = cuda_ms(torch, lambda: fb.flash_bwd_dkv_cuda(*kargs))
    plain_ms = cuda_ms(torch, lambda: bwd_plain(args), iters=1, warmup=1)
    qt = qr.clone().requires_grad_(True)
    kt.requires_grad_(True)
    vt.requires_grad_(True)
    o = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=live[:, None], scale=scale,
                                       enable_gqa=True)
    do_t = dout.transpose(1, 2).contiguous()
    sdpa_ms, backend, names = sdpa_bwd_device_ms(
        torch, lambda: torch.autograd.grad(o, (qt, kt, vt), do_t, retain_graph=True), calls=3)
    del qt, kt, vt, o, do_t, qr
    ins = (q.numel() + dout.numel() + k.numel() + v.numel()) * 2 + lse.numel() * 8 + 2 * S * 8
    b9 = bound(ins + q.numel() * 4, 3 * gemm)
    b10 = bound(ins + 2 * H * S * D * 4, 4 * gemm)
    sdpa = "not measured" if sdpa_ms is None else f"{sdpa_ms:.4f}"
    say(f"    K9 {ms9:.4f} ms ({3 * gemm / ms9 / 1e9:.1f} TFLOP/s on {pairs} live pairs), bound "
        f"{b9[0]:.4f} ({b9[1]}); K10 {ms10:.4f} ms ({4 * gemm / ms10 / 1e9:.1f} TFLOP/s), bound "
        f"{b10[0]:.4f} ({b10[1]}); plain (both passes) {plain_ms:.4f}; SDPA's backward with the "
        f"boolean mask, device time {sdpa} (backend {backend}: {', '.join(names)[:200]})")
    for key, line, ms, b in (("K9", 127, ms9, b9), ("K10", 194, ms10, b10)):
        rows[f"{key} local seg"] = dict(
            name=f"flash_bwd {'dq' if key == 'K9' else 'dk/dv'} pass, kLocal and kOpt, the "
                 f"window on the indices (B=1, documents {MISTRAL_TRAIN_DOCS} in {S}, H={H}, "
                 f"Hk={Hk}, D=128, segment ids alone, window {window}, causal, rope: "
                 f"Mistral-7B's training backward)",
            source="flash_attn_tpu_torch/csrc/flash_bwd.cu",
            replaces=f"flash_attn_tpu/ops/flash_bwd.py:{line}", max_abs_err=worst[key], ms=ms,
            plain_ms=plain_ms, library_ms=sdpa_ms, bound_ms=b[0], bound_by=b[1],
            live_pairs=pairs)
    del rq, lse, delta
    torch.cuda.empty_cache()

    # checked only: the window on the positions, and cap 5 on the indices
    for what, m, cap in (("segment ids and positions, the window on the positions",
                          ff.Masks(seg, seg, pos, pos), None),
                         ("segment ids alone, the window on the indices, cap 5", masks, 5.0)):
        out, lse = ff.flash_fwd_cuda(q, k, v, True, scale, cos, sin, False, m, window, cap)
        rout, rlse = fwd_plain((q, k, v, True, scale, cos, sin, False, m, window, cap))
        torch.cuda.synchronize()
        err, share = row_err(out, rout)
        lerr = float((lse - rlse).abs().max())
        label = f"local seg, documents {MISTRAL_TRAIN_DOCS} in {S}, {what}"
        ok = (checks.check(f"K4 {label} out", share, 1.0)
              & checks.check(f"K4 {label} lse", lerr, 1e-3))
        say(f"  K4 {label}: max_abs_err {err:.3e} ({share:.3f} of its row's tol), lse err "
            f"{lerr:.3e} (tol 1e-3) {'ok' if ok else 'FAIL'}")
        delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        del out, rout, rlse
        args = (q, k, v, dout, lse, delta, True, scale, cos, sin, window, cap, m)
        tail = (k, v, dout, lse, delta, True, scale, window, cap, m)
        dq, rq, dk, dv, res = _bwd_case(torch, checks, worst, label, args, tail, True, floor)
        say(f"  K9 {label}: {res['K9']}")
        say(f"  K10 {label}: {res['K10']}")
        del dq, rq, dk, dv, lse, delta
        torch.cuda.empty_cache()
    for key in ("K9", "K10"):
        rows[f"{key} local seg"]["max_abs_err"] = worst[key]
    del q, k, v, dout, live, counts


# --- the FA2 options of the C ABI: an additive bias, dropout, segment ids ---
# --- and positions in K4, K9 and K10 (the kExtra and kOpt instances) -------

# phase 18's varlen calls: 8 sequences packed in 8192 tokens; phase 19's
# documents packed in one 2048-token row; the dropout of both phases
ABI_LENS = (2048, 1536, 1280, 1024, 896, 640, 512, 256)
# varlen at GPT-2's widths: 8 sequences of at most its 1024 positions
GPT2_LENS = (1024, 896, 640, 512, 512, 256, 192, 64)
PACKED_DOCS = (1024, 512, 320, 192)
DROP_RATE, DROP_SEED = 0.1, 1234


def _cu(torch, lens):
    """[len + 1] int32 prefix sums of ``lens`` on the card."""
    import itertools

    return torch.tensor([0, *itertools.accumulate(lens)], dtype=torch.int32, device="cuda")


def _varlen_masks(torch, lens):
    """The masks the varlen entry points give K4, K9 and K10 for sequences
    ``lens`` packed in one row, causal in each (``varlen_segments``:
    segment ids and positions, no causal flag)."""
    from flash_attn_tpu_torch.ops import flash_fwd as ff
    from flash_attn_tpu_torch.ops.attention import varlen_segments

    cu = _cu(torch, lens)
    qs, ks, qp, kp, _ = varlen_segments(cu, cu, sum(lens), sum(lens), True)
    return ff.Masks(qs, ks, qp, kp)


def _packed_docs(torch, docs, device="cuda"):
    """([1, S] segment ids 1, 2, ... a document, [1, S] positions
    restarting at 0 a document) of documents ``docs`` packed in one row."""
    seg = torch.cat([torch.full((n,), i + 1, dtype=torch.int32) for i, n in enumerate(docs)])
    pos = torch.cat([torch.arange(n) for n in docs])
    return seg[None].to(device), pos[None].to(device)


def _rand_bias(torch, g, shape, dead_row=3):
    """An fp32 bias N(0, 1) of ``shape``, a sixteenth of its entries -inf
    and, where it has rows, the whole row ``dead_row``."""
    b = torch.randn(shape, generator=g, device="cuda")
    b = b.masked_fill(torch.rand(shape, generator=g, device="cuda") < 1 / 16, float("-inf"))
    if len(shape) >= 2 and dead_row is not None:
        b[..., dead_row, :] = float("-inf")
    return b


# the bias forms that K9's and K10's staging (csrc/flash_bwd.cu:load_bias)
# must take, each at head_dim 128 and 64, causal or not: (B, Sq, Sk, H,
# Hk, D, causal, kind, dropout).  Kinds (_edge_bias): "keys", a key-padding
# bias [B, 1, 1, Sk] (query stride 0); "rows", a contiguous [Sq, Sk] whose
# rows are not 16-byte aligned (Sk odd: 4-byte pieces; Sk = 2 mod 4:
# 8-byte pieces); "transposed", the transpose of a [B, H, Sk, Sq] tensor
# (key stride Sq: 4-byte pieces)
FA2_EDGE_BIAS = (
    (2, 1000, 1500, 32, 8, 128, True, "keys", False),
    (2, 1024, 1024, 12, 12, 64, False, "keys", True),
    (1, 1000, 1501, 32, 8, 128, False, "rows", False),
    (2, 1000, 1501, 12, 4, 64, True, "rows", True),
    (1, 1000, 1502, 32, 8, 128, True, "rows", False),
    (1, 1000, 1500, 32, 8, 128, False, "transposed", True),
    (2, 1024, 1024, 12, 12, 64, True, "transposed", False),
)


def _edge_bias(torch, g, kind, B, H, Sq, Sk):
    """A bias of FA2_EDGE_BIAS's ``kind`` as _rand_bias draws it (the
    transposed one with query row 3 all -inf)."""
    if kind == "keys":
        return _rand_bias(torch, g, (B, 1, 1, Sk), dead_row=None)
    if kind == "rows":
        return _rand_bias(torch, g, (Sq, Sk))
    if kind != "transposed":
        raise ValueError(f"unknown bias kind {kind!r}")
    bias = _rand_bias(torch, g, (B, H, Sk, Sq), dead_row=None).transpose(-1, -2)
    bias[..., 3, :] = float("-inf")
    return bias


def _live_keys(torch, masks, causal, Sq, Sk, bias, H):
    """[B, Sq, H] live keys a query: the masks' pairs whose bias is
    finite."""
    from flash_attn_tpu_torch.ops import flash_fwd as ff

    live = ff.live_pairs(masks, causal, Sq, Sk, "cuda")
    if bias is None:
        return live.sum(-1)[..., None].expand(-1, -1, H)
    if bias.stride(1) == 0:
        return (live & torch.isfinite(bias[:, 0])).sum(-1)[..., None].expand(-1, -1, H)
    return torch.stack([(live & torch.isfinite(bias[:, h])).sum(-1) for h in range(H)], -1)


def _bias_bytes(torch, b4, live):
    """(once, per_head): the bytes of the fp32 bias ``b4`` ([B, H, Sq, Sk]
    view) at the pairs ``live`` ([B or 1, Sq, Sk]) keeps, each distinct
    entry once, and once for every (batch, query head) that reads it."""
    if b4 is None:
        return 0, 0
    B, H = b4.shape[:2]
    live = live.expand(B, -1, -1)
    per_head = 4 * H * int(live.sum())
    once = live
    for axis, dim in ((0, 0), (2, 1), (3, 2)):
        if b4.stride(axis) == 0:
            once = once.any(dim, keepdim=True)
    return 4 * int(once.sum()) * (1 if b4.stride(1) == 0 else H), per_head


def _opt_label(B, Sq, Sk, H, Hk, D, causal, masks, bias, dropout, what=""):
    return (f"B={B}, " + (f"S={Sq}" if Sq == Sk else f"Sq={Sq}, Sk={Sk}") + f", H={H}, Hk={Hk}, "
            f"D={D}, {'causal' if causal else 'not causal'}"
            + (f", {what}" if what else "")
            + (f", bias {list(bias.shape) if bias.dim() < 4 else 'view'}"
               if bias is not None else "")
            + (f", dropout {dropout.rate} seed {dropout.seed}" if dropout is not None else ""))


def _k4_opt_case(torch, checks, label, q, k, v, causal, masks, bias, dropout):
    """K4's kExtra instance (its masked twin with masks) launched twice on
    these options against its plain version (fwd_plain): each out row
    within two bf16 ulps of its largest, the LSE of live rows to 1e-3,
    rows with no live key (every key masked or -inf) out 0 and lse -1e30,
    the second launch bitwise the first.  ``bias``: as flash_fwd takes it
    (any shape that broadcasts).  Returns (max |err|, K4's arguments)."""
    from flash_attn_tpu_torch.ops import flash_fwd as ff

    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    args = (q, k, v, causal, D ** -0.5, None, None, False, masks, None, None,
            ff.bias4(bias, B, H, Sq, Sk), dropout)
    (out, lse), (out2, lse2) = ff.flash_fwd_cuda(*args), ff.flash_fwd_cuda(*args)
    rout, rlse = fwd_plain(args)
    torch.cuda.synchronize()
    err, share = row_err(out, rout)
    live = rlse > -1e29
    lerr = float((lse - rlse).abs()[live].max())
    dead = ~live
    dead_ok = bool((lse[dead] == -1e30).all() and (out.transpose(1, 2)[dead] == 0).all())
    same = torch.equal(out, out2) and torch.equal(lse, lse2)
    ok = checks.check(f"K4 {label} out", share, 1.0) & checks.check(f"K4 {label} lse", lerr, 1e-3)
    if not dead_ok:
        checks.failed.append(f"K4 {label}: a row with no live key is not out 0 / lse -1e30")
    if not same:
        checks.failed.append(f"K4 {label}: two launches differ")
    say(f"  K4 {label}: max_abs_err {err:.3e} ({share:.3f} of its row's tol), lse err "
        f"{lerr:.3e} (tol 1e-3), {int(dead.sum())} dead rows out 0 and lse -1e30 {dead_ok}, "
        f"bitwise repeat {same} {'ok' if ok and dead_ok and same else 'FAIL'}")
    del out, lse, out2, lse2, rout, rlse
    return err, args


def _sdpa_mask(torch, masks, causal, Sq, Sk, bias):
    """SDPA's float attn_mask for these options: the bias ([B or 1, H or 1,
    Sq, Sk]; 0 without one) plus -inf where the masks kill a pair."""
    from flash_attn_tpu_torch.ops import flash_fwd as ff

    live = ff.live_pairs(masks, causal, Sq, Sk, "cuda")[:, None]
    if bias is None:
        return torch.zeros(live.shape, device="cuda").masked_fill(~live, float("-inf"))
    b = bias[:, :1] if bias.stride(1) == 0 else bias
    b = b[:1] if b.stride(0) == 0 else b
    return b.masked_fill(~live, float("-inf")).contiguous()


def _k4_opt_times(torch, args, masks, causal):
    """The kernel's time (CUDA events), the plain version's, SDPA's with the
    same float attn_mask and no dropout (SDPA's dropout draws another
    mask: the same function only where dropout is off), and the bound:
    q, k, v and out in bf16, the LSE, the masks' metadata and the bias at
    the pairs the masks keep, read once (also read once a head:
    ``bound_per_head``), against 4 D flops a pair the masks keep."""
    import torch.nn.functional as F

    from flash_attn_tpu_torch.ops import flash_fwd as ff

    q, k, v = args[:3]
    bias = args[11]
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    ms = cuda_ms(torch, lambda: ff.flash_fwd_cuda(*args))
    plain_ms = cuda_ms(torch, lambda: fwd_plain(args), iters=1, warmup=1)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    fm = _sdpa_mask(torch, masks, causal, Sq, Sk, bias)
    sdpa_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=fm, scale=D ** -0.5, enable_gqa=True), iters=5)
    del qt, kt, vt, fm
    live = ff.live_pairs(masks, causal, Sq, Sk, "cuda")
    pairs = int(live.sum()) * (1 if masks is not None else B)
    flops = 4 * D * H * pairs
    bias_bytes, per_head = _bias_bytes(torch, bias, live)
    del live
    meta = 0 if masks is None else (Sq + Sk) * B * 8
    nbytes = (q.numel() * 2 + k.numel() * 2) * 2 + B * H * Sq * 4 + meta
    b_ms, b_by = bound(nbytes + bias_bytes, flops)
    bh_ms, bh_by = bound(nbytes + per_head, flops)
    return dict(ms=ms, plain_ms=plain_ms, sdpa_mask_ms=sdpa_ms, bound_ms=b_ms, bound_by=b_by,
                bound_per_head_ms=bh_ms, bound_per_head_by=bh_by, live_pairs=pairs,
                bias_bytes=bias_bytes)


def _say_opt_times(kernel, t):
    say(f"    {kernel} {t['ms']:.4f} ms ({t.get('tflops', 0.0):.1f} TFLOP/s on "
        f"{t['live_pairs']} live pairs), plain {t['plain_ms']:.4f}, SDPA with the float mask "
        f"and no dropout {t['sdpa_mask_ms']:.4f}, bound {t['bound_ms']:.4f} ({t['bound_by']}; "
        f"the bias read once), {t['bound_per_head_ms']:.4f} ({t['bound_per_head_by']}) with the "
        f"bias read once a head")


def _bwd_opt_case(torch, checks, worst, label, q, k, v, dout, causal, masks, bias, dropout,
                  cos=None, sin=None, timed=False):
    """K9's and K10's kOpt instances on these options (out and lse from K4
    with the same ones) through _bwd_case: each launched twice, against
    flash_bwd_plain over head groups, dq rows of queries with fewer than
    two live keys (the masks' pairs with a finite bias) held to the noise
    floor of one_key_floor.  With ``timed`` the kernels' times (CUDA
    events), the plain version's, SDPA's backward with the same float
    attn_mask and no dropout (device time by torch.profiler) and the
    bounds (3 and 4 products of 2 D flops a live pair; q, k, v, dout in
    bf16, lse and delta, the bias at the live pairs once, dq or dk and dv
    per query head in fp32).  Returns the times or None."""
    import torch.nn.functional as F

    from flash_attn_tpu_torch.ops import flash_bwd as fb
    from flash_attn_tpu_torch.ops import flash_fwd as ff
    from flash_attn_tpu_torch.ops.rope import rope_rotate

    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    scale = D ** -0.5
    b4 = ff.bias4(bias, B, H, Sq, Sk)
    out, lse = ff.flash_fwd_cuda(q, k, v, causal, scale, cos, sin, False, masks, None, None, b4,
                                 dropout)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    del out
    args = (q, k, v, dout, lse, delta, causal, scale, cos, sin, None, None, masks, b4, dropout)
    tail = (k, v, dout, lse, delta, causal, scale, None, None, masks, b4, dropout)
    counts = _live_keys(torch, masks, causal, Sq, Sk, b4, H)

    def floor(rdq):
        return torch.where(counts < 2, 2.0 ** -12 * float(rdq.abs().max()), 1e-6)

    dq, rq, dk, dv, res = _bwd_case(torch, checks, worst, label, args, tail, causal, floor)
    say(f"  K9 {label}: {res['K9']}")
    say(f"  K10 {label}: {res['K10']}")
    del dq, dk, dv
    if not timed:
        return None
    kargs = (rq, *tail)
    ms9 = cuda_ms(torch, lambda: fb.flash_bwd_dq_cuda(*args))
    ms10 = cuda_ms(torch, lambda: fb.flash_bwd_dkv_cuda(*kargs))
    plain_ms = cuda_ms(torch, lambda: bwd_plain(args), iters=1, warmup=1)
    qt = (q if cos is None else rope_rotate(q, cos, sin)).transpose(1, 2).contiguous()
    qt.requires_grad_(True)
    kt = k.transpose(1, 2).contiguous().requires_grad_(True)
    vt = v.transpose(1, 2).contiguous().requires_grad_(True)
    fm = _sdpa_mask(torch, masks, causal, Sq, Sk, b4)
    o = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=fm, scale=scale, enable_gqa=True)
    do_t = dout.transpose(1, 2).contiguous()

    def lib_call():
        return torch.autograd.grad(o, (qt, kt, vt), do_t, retain_graph=True)
    sdpa_ms, backend, names = sdpa_bwd_device_ms(torch, lib_call, calls=3)
    del qt, kt, vt, o, fm
    live = ff.live_pairs(masks, causal, Sq, Sk, "cuda")
    pairs = int(live.sum()) * (1 if masks is not None else B)
    gemm = 2 * D * H * pairs
    bias_bytes = _bias_bytes(torch, b4, live)[0]
    del live
    meta = 0 if masks is None else (Sq + Sk) * B * 8
    ins = (q.numel() + dout.numel() + k.numel() + v.numel()) * 2 + lse.numel() * 8 + bias_bytes
    b9 = bound(ins + meta + q.numel() * 4, 3 * gemm)
    b10 = bound(ins + meta + 2 * B * H * Sk * D * 4, 4 * gemm)
    sdpa = "not measured" if sdpa_ms is None else f"{sdpa_ms:.4f}"
    say(f"    K9 {ms9:.4f} ms ({3 * gemm / ms9 / 1e9:.1f} TFLOP/s on {pairs} live pairs), bound "
        f"{b9[0]:.4f} ({b9[1]}); K10 {ms10:.4f} ms ({4 * gemm / ms10 / 1e9:.1f} TFLOP/s), bound "
        f"{b10[0]:.4f} ({b10[1]}); plain (both passes) {plain_ms:.4f}; SDPA's backward with the "
        f"float mask and no dropout, device time {sdpa} (backend {backend}: "
        f"{', '.join(names)[:200]})")
    return {"K9": dict(ms=ms9, plain_ms=plain_ms, bound_ms=b9[0], bound_by=b9[1],
                       sdpa_mask_ms=sdpa_ms),
            "K10": dict(ms=ms10, plain_ms=plain_ms, bound_ms=b10[0], bound_by=b10[1],
                        sdpa_mask_ms=sdpa_ms)}


def check_dropout_readout(torch, checks):
    """K4's and K10's dropout read out bit for bit.  q = k = 0, so P is
    uniform over the live keys; a bias keeps the D keys from c0 (-inf on
    the others); V is one-hot on those keys, so K4's out[i, j] = keep(i,
    c0 + j) / (D (1 - rate)): nonzero exactly where dropout_keep_mask
    keeps (i, c0 + j).  K10, with dout one-hot on the D query rows from
    r0, writes dv[c0 + kk, j] = keep(r0 + j, c0 + kk) / (D (1 - rate)) per
    query head.  B=2, S=8192, H=4, Hk=2, D=128, not causal, rate 0.1,
    three (c0, r0), every (b, h): the mismatches must be 0."""
    from flash_attn_tpu_torch.ops import flash_bwd as fb
    from flash_attn_tpu_torch.ops import flash_fwd as ff

    B, S, H, Hk, D = 2, 8192, 4, 2, 128
    drop = ff.Dropout(DROP_RATE, DROP_SEED)
    q = torch.zeros((B, S, H, D), device="cuda", dtype=torch.bfloat16)
    k = torch.zeros((B, S, Hk, D), device="cuda", dtype=torch.bfloat16)
    eye = torch.eye(D, device="cuda", dtype=torch.bfloat16)
    bad4 = bad10 = n4 = n10 = 0
    for c0, r0 in ((0, 0), (1000, 4000), (S - D - 5, S - D)):
        bias = torch.full((S,), float("-inf"), device="cuda")
        bias[c0:c0 + D] = 0.0
        b4 = ff.bias4(bias, B, H, S, S)
        v = torch.zeros((B, S, Hk, D), device="cuda", dtype=torch.bfloat16)
        v[:, c0:c0 + D] = eye[:, None, :]
        out, lse = ff.flash_fwd_cuda(q, k, v, False, D ** -0.5, None, None, False, None, None,
                                     None, b4, drop)
        dout = torch.zeros_like(q)
        dout[:, r0:r0 + D] = eye[:, None, :]
        delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        _, dv = fb.flash_bwd_dkv_cuda(q, k, v, dout, lse, delta, False, D ** -0.5, None, None,
                                      None, b4, drop)
        for b in range(B):
            for h in range(H):
                want = ff.dropout_keep_mask(DROP_SEED, b, h, 0, c0, S, D, DROP_RATE, "cuda")
                bad4 += int(((out[b, :, h] != 0) != want).sum())
                n4 += want.numel()
                want = ff.dropout_keep_mask(DROP_SEED, b, h, r0, c0, D, D, DROP_RATE, "cuda")
                bad10 += int(((dv[b, h, c0:c0 + D] != 0).T != want).sum())
                n10 += want.numel()
        del out, lse, dout, delta, dv, v
    ok = checks.check("K4 dropout readout mismatches", bad4, 0) & checks.check(
        "K10 dropout readout mismatches", bad10, 0)
    say(f"  dropout readout (B={B}, S={S}, H={H}, Hk={Hk}, D={D}, rate {DROP_RATE}, seed "
        f"{DROP_SEED}; c0 0, 1000, {S - D - 5}): K4 out != 0 against dropout_keep_mask, "
        f"{bad4} of {n4} elements differ; K10 dv (dout one-hot on rows 0, 4000, {S - D}), "
        f"{bad10} of {n10} differ {'ok' if ok else 'FAIL'}")
    return dict(k4_elements=n4, k4_mismatches=bad4, k10_elements=n10, k10_mismatches=bad10)


def check_extra_neutral(torch, checks):
    """The new instances with neutral options against the instances they
    sit beside, at the Llama training shape (B=1, S=2048, H=32, Hk=8,
    causal): K4's kExtra instance with a zero bias against the plain K4
    instance, K9's and K10's kOpt instances with a zero bias against
    theirs.  Adding 0 and clamping at -1e30 changes no score, so the
    outputs must be bitwise equal."""
    from flash_attn_tpu_torch.ops import flash_bwd as fb
    from flash_attn_tpu_torch.ops import flash_fwd as ff

    g = torch.Generator(device="cuda").manual_seed(SEED + 70)
    B, S, H, Hk, D = 1, 2048, 32, 8, 128
    q = torch.randn((B, S, H, D), generator=g, device="cuda", dtype=torch.bfloat16)
    k = torch.randn((B, S, Hk, D), generator=g, device="cuda", dtype=torch.bfloat16)
    v = torch.randn((B, S, Hk, D), generator=g, device="cuda", dtype=torch.bfloat16)
    dout = torch.randn((B, S, H, D), generator=g, device="cuda", dtype=torch.bfloat16)
    zero = ff.bias4(torch.zeros((S, S), device="cuda"), B, H, S, S)
    base = (q, k, v, True, D ** -0.5, None, None, False)
    o1, l1 = ff.flash_fwd_cuda(*base)
    o2, l2 = ff.flash_fwd_cuda(*base, None, None, None, zero)
    delta = (dout.float() * o1.float()).sum(-1).transpose(1, 2).contiguous()
    bargs = (q, k, v, dout, l1, delta, True, D ** -0.5, None, None)
    g1 = fb.flash_bwd_cuda(*bargs)
    g2 = fb.flash_bwd_cuda(*bargs, None, None, None, zero)
    same = {"K4": torch.equal(o1, o2) and torch.equal(l1, l2),
            "K9": torch.equal(g1[0], g2[0]),
            "K10": torch.equal(g1[1], g2[1]) and torch.equal(g1[2], g2[2])}
    for key, eq in same.items():
        if not eq:
            checks.failed.append(f"{key}: the new instance with a zero bias differs from the "
                                 "instance beside it")
    say(f"  new instances with a zero bias against the ones beside them (B={B}, S={S}, H={H}, "
        f"Hk={Hk}, D={D}, causal): bitwise " + ", ".join(f"{k_} {v_}" for k_, v_ in same.items()))


def check_fa2_options(torch, checks, rows):
    """K4's kExtra instances (bias, dropout; with and without segment ids
    and positions) and K9's and K10's kOpt instances (segment ids,
    positions, bias, dropout) at head_dim 128 and 64 against their plain
    versions (rows "K4 opt", "K9 opt", "K10 opt": phase 18's varlen call,
    8 sequences in 8192 tokens at Llama-3-8B's attention widths, causal in
    each, a [8192, 8192] mask and dropout 0.1; sub-points: the same
    without the mask, with the segments alone, the dense call (B=2, S=2048, a [2, 1, 2048, 2048]
    mask, dropout), the bias alone (where SDPA computes the same function),
    GPT-2's widths dense (B=4, S=1024, H=Hk=12, D=64) and varlen (8
    sequences in 4096 tokens, GPT2_LENS, with a [4096, 4096] mask and
    dropout, and with the segments alone)), the bias forms of
    FA2_EDGE_BIAS (a key-padding bias, rows not 16-byte aligned, a
    transposed view; each at head_dim 128 and 64), the backward also
    at phase 19's packed documents with rope and at a ragged non-causal
    Sq=1000 Sk=1500 with a per-head bias; the dropout read out bit for bit
    (check_dropout_readout); and the new instances with neutral options
    bitwise the instances beside them (check_extra_neutral)."""
    from flash_attn_tpu_torch.ops import flash_fwd as ff
    from flash_attn_tpu_torch.ops.rope import rope_cos_sin

    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(SEED + 71)
    drop = ff.Dropout(DROP_RATE, DROP_SEED)
    total = sum(ABI_LENS)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda", dtype=torch.bfloat16)

    vmask = _varlen_masks(torch, ABI_LENS)
    vmask64, total64 = _varlen_masks(torch, GPT2_LENS), sum(GPT2_LENS)
    # (key, B, Sq, Sk, H, Hk, D, causal, masks, bias shape, dropout, timed)
    cases = (
        ("", 1, total, total, 32, 8, 128, False, vmask, (total, total), drop, True),
        ("no_mask", 1, total, total, 32, 8, 128, False, vmask, None, drop, True),
        # the masks alone: K4's masked instance, K9's and K10's kOpt ones
        # without bias and dropout (what the bias and the hash cost, beside
        # the two rows above)
        ("segments", 1, total, total, 32, 8, 128, False, vmask, None, None, True),
        ("dense", 2, 2048, 2048, 32, 8, 128, True, None, (2, 1, 2048, 2048), drop, True),
        ("bias", 2, 2048, 2048, 32, 8, 128, True, None, (2, 1, 2048, 2048), None, True),
        ("d64", 4, 1024, 1024, 12, 12, 64, True, None, (4, 1, 1024, 1024), drop, True),
        # head_dim 64 with segment ids and positions: K4's kExtra masked
        # instance, then K4's masked one; K9's and K10's kOpt tile lists
        ("d64_varlen", 1, total64, total64, 12, 12, 64, False, vmask64, (total64, total64),
         drop, True),
        ("d64_segments", 1, total64, total64, 12, 12, 64, False, vmask64, None, None, True),
        (None, 1, 1000, 1500, 32, 8, 128, False, None, (1, 32, 1000, 1500), drop, False),
        (None, 2, 1000, 1500, 12, 4, 64, True, None, (1000, 1500), None, False),
        (None, 1, 891, 891, 32, 8, 128, True, None, None, drop, False),
        # the bias forms K9's and K10's staging must take (a bias kind)
        *((None, B_, Sq_, Sk_, H_, Hk_, D_, causal_, None, kind, drop if d else None, False)
          for B_, Sq_, Sk_, H_, Hk_, D_, causal_, kind, d in FA2_EDGE_BIAS),
    )
    worst = {"K4 opt": 0.0, "K9 opt": 0.0, "K10 opt": 0.0}
    k4_rows, bwd_rows = {}, {}
    for key, B, Sq, Sk, H, Hk, D, causal, masks, bshape, dropout, timed in cases:
        q, k, v, dout = rnd(B, Sq, H, D), rnd(B, Sk, Hk, D), rnd(B, Sk, Hk, D), rnd(B, Sq, H, D)
        what = "varlen, 8 sequences" if masks is not None else ""
        if isinstance(bshape, str):
            bias = _edge_bias(torch, g, bshape, B, H, Sq, Sk)
            what = f"a {bshape} bias, strides {tuple(bias.stride())}"
        else:
            bias = None if bshape is None else _rand_bias(torch, g, bshape)
        label = _opt_label(B, Sq, Sk, H, Hk, D, causal, masks, bias, dropout, what)
        err, args = _k4_opt_case(torch, checks, label, q, k, v, causal, masks, bias, dropout)
        worst["K4 opt"] = max(worst["K4 opt"], err)
        if timed:
            t = _k4_opt_times(torch, args, masks, causal)
            t["tflops"] = 4 * D * H * t["live_pairs"] / t["ms"] / 1e9
            _say_opt_times("K4", t)
            k4_rows[key] = t
        del args
        bw = {"K9": 0.0, "K10": 0.0}
        t = _bwd_opt_case(torch, checks, bw, label, q, k, v, dout, causal, masks, bias, dropout,
                          timed=timed)
        worst["K9 opt"] = max(worst["K9 opt"], bw["K9"])
        worst["K10 opt"] = max(worst["K10 opt"], bw["K10"])
        if timed:
            bwd_rows[key] = t
        del q, k, v, dout, bias
        torch.cuda.empty_cache()
    # phase 19's packed documents: causal with segment ids and rope (K4's
    # masked instance, K9's and K10's kOpt instances)
    S = sum(PACKED_DOCS)
    seg, pos = _packed_docs(torch, PACKED_DOCS)
    cos, sin = rope_cos_sin(pos, 128, 500000.0)
    masks = ff.Masks(seg, seg, None, None)
    bw = {"K9": 0.0, "K10": 0.0}
    _bwd_opt_case(torch, checks, bw, f"B=1, S={S}, H=32, Hk=8, D=128, causal, segment ids "
                  f"(documents {PACKED_DOCS}), rope", rnd(1, S, 32, 128), rnd(1, S, 8, 128),
                  rnd(1, S, 8, 128), rnd(1, S, 32, 128), True, masks, None, None, cos, sin)
    worst["K9 opt"] = max(worst["K9 opt"], bw["K9"])
    worst["K10 opt"] = max(worst["K10 opt"], bw["K10"])
    readout = check_dropout_readout(torch, checks)
    check_extra_neutral(torch, checks)
    torch.cuda.empty_cache()
    main = f"varlen, 8 sequences in {total} tokens, H=32, Hk=8, D=128, causal in each, a " \
           f"[{total}, {total}] fp32 mask, dropout {DROP_RATE}"
    for key, name, ref, parts in (
            ("K4 opt", "flash_fwd with a bias, dropout, segment ids and positions",
             "flash_fwd.py:221", k4_rows),
            ("K9 opt", "flash_bwd dq pass with segment ids, positions, a bias and dropout",
             "flash_bwd.py:127", {n: t["K9"] for n, t in bwd_rows.items()}),
            ("K10 opt", "flash_bwd dk/dv pass with segment ids, positions, a bias and dropout",
             "flash_bwd.py:194", {n: t["K10"] for n, t in bwd_rows.items()})):
        top = parts[""]
        rows[key] = dict(
            name=f"{name} ({main})",
            source=f"flash_attn_tpu_torch/csrc/{ref.split('.')[0]}.cu",
            replaces=f"flash_attn_tpu/ops/{ref}", max_abs_err=worst[key], ms=top["ms"],
            plain_ms=top["plain_ms"], bound_ms=top["bound_ms"], bound_by=top["bound_by"],
            # SDPA's dropout draws another mask: no library call computes this
            library_ms=None, sdpa_mask_ms=top["sdpa_mask_ms"],
            # the bias alone is SDPA's function with the same float mask
            **{n: dict(t, library_ms=t["sdpa_mask_ms"] if n == "bias" else None)
               for n, t in parts.items() if n})
    rows["K4 opt"]["bound_per_head_ms"] = k4_rows[""]["bound_per_head_ms"]
    rows["K4 opt"]["readout"] = readout
    say(f"  FA2 options: {time.perf_counter() - t0:.2f}s")


# ---------------------------------------------------------------- the FA2 surface (ALiBi, dbias, probs, verify)

# (key, B, Sq, Sk, H, Hk, D, causal, rope, masks, dropout): ALiBi's points.
# Llama-3-8B's attention widths (H=32, D=128, which are also MPT-7B's and
# BLOOM-7B1's, the public ALiBi models; Hk=8), causal with rope, the
# training shape first (the rows themselves); the bottom-right shift with
# ragged tiles; packed documents (segment ids, phase 19's) with dropout
# 0.1, where ALiBi measures the packed indices as JAX's does; GPT-2's
# widths (H = Hk = 12, D=64, B=8, S=1024), whose 12 heads take the
# interleaved schedule
ALIBI_POINTS = (
    ("", 1, 2048, 2048, 32, 8, 128, True, True, None, False),
    ("shifted", 1, 1000, 1500, 32, 8, 128, True, True, None, False),
    ("segments_dropout", 1, 2048, 2048, 32, 8, 128, True, True, "docs", True),
    ("gpt2", 8, 1024, 1024, 12, 12, 64, True, False, None, False),
)
# (key, bias shape, dropout): dbias at 8B widths, B=2, S=2048, causal,
# dense: a learned per-head relative-position bias shared over the batch
# (T5's form), summed over the batch; a per-sequence bias, summed over the
# heads; the first with dropout 0.1
DBIAS_POINTS = (("", (1, 32, 2048, 2048), False), ("heads_summed", (2, 1, 2048, 2048), False),
                ("dropout", (1, 32, 2048, 2048), True))


def _alibi_mask(torch, slopes, Sq, Sk, causal):
    """ALiBi as SDPA's fp32 float mask [1, H, Sq, Sk]: -slope_h |i + Sk -
    Sq - j|, -inf above the diagonal when causal (the same function)."""
    from flash_attn_tpu_torch.ops import flash_fwd as ff

    m = -slopes.float()[:, None, None] * ff.alibi_dist(Sq, Sk, "cuda")[None]
    if causal:
        m = m.masked_fill(~ff.live_pairs(None, True, Sq, Sk, "cuda")[0], float("-inf"))
    return m[None]


def _surface_inputs(torch, g, B, Sq, Sk, H, Hk, D, rope, masks, q_mult=1.0):
    """q (times ``q_mult``), k, v, dout in bf16, the rope tables (each
    sequence its own positions) and the masks (``"docs"``: phase 19's
    packed documents, segment ids and positions restarting)."""
    from flash_attn_tpu_torch.ops import flash_fwd as ff
    from flash_attn_tpu_torch.ops.rope import rope_cos_sin

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda", dtype=torch.bfloat16)

    q, k, v, dout = rnd(B, Sq, H, D) * q_mult, rnd(B, Sk, Hk, D), rnd(B, Sk, Hk, D), rnd(B, Sq, H, D)
    cos = sin = m = None
    if masks == "docs":
        seg, pos = _packed_docs(torch, PACKED_DOCS)
        m = ff.Masks(seg, seg, None, None)
        cos, sin = rope_cos_sin(pos, D, 500000.0)
    elif rope:
        pos = torch.arange(Sq, device="cuda")[None] + 7 * torch.arange(B, device="cuda")[:, None]
        cos, sin = rope_cos_sin(pos, D, 500000.0)
    return q, k, v, dout, cos, sin, m


def _k4_surface_case(torch, checks, worst, label, args, kw):
    """K4's kExtra instance with ``kw`` (ALiBi slopes, probs, verify)
    launched twice against fwd_plain with the same: out rows to two bf16
    ulps, the lse of live rows to 1e-3, rows with no live key out 0 and lse
    -1e30, the second launch bitwise the first; with probs the
    probabilities (softmax_probs of each side's tiles) row by row to 2^-10
    of the row's largest plus 1e-7; with verify the flags exactly.
    Returns (kernel's results, plain's results)."""
    from flash_attn_tpu_torch.ops import flash_fwd as ff

    Sk = args[1].shape[1]
    got, got2 = ff.flash_fwd_cuda(*args, **kw), ff.flash_fwd_cuda(*args, **kw)
    ref = fwd_plain(args, **kw)
    torch.cuda.synchronize()
    out, lse, rout, rlse = got[0], got[1], ref[0], ref[1]
    err, share = row_err(out, rout)
    live = rlse > -1e29
    lerr = float((lse - rlse).abs()[live].max()) if bool(live.any()) else 0.0
    dead_ok = bool((lse[~live] == -1e30).all() and (out.transpose(1, 2)[~live] == 0).all())
    same = all(torch.equal(a, b) for a, b in zip(got, got2) if a is not None)
    ok = checks.check(f"K4 {label} out", share, 1.0) & checks.check(f"K4 {label} lse", lerr,
                                                                      1e-3)
    worst["K4"] = max(worst["K4"], err)
    text = (f"max_abs_err {err:.3e} ({share:.3f} of its row's tol), lse err {lerr:.3e}, "
            f"{int((~live).sum())} dead rows ok {dead_ok}, bitwise repeat {same}")
    if not dead_ok:
        checks.failed.append(f"K4 {label}: a row with no live key is not out 0 / lse -1e30")
    if not same:
        checks.failed.append(f"K4 {label}: two launches differ")
    if kw.get("probs"):
        p, rp = ff.softmax_probs(got[2], got[3], lse, Sk), ff.softmax_probs(ref[2], ref[3], rlse,
                                                                              Sk)
        perr, pshare = row_err(p, rp, rel=2.0 ** -10, floor=1e-7)
        ok &= checks.check(f"K4 {label} probs", pshare, 1.0)
        text += f", P max_abs_err {perr:.3e} ({pshare:.3f} of its row's tol)"
        got = (out, lse, p)
        ref = (rout, rlse, rp)
    if kw.get("verify"):
        diff = int((got[2] != ref[2]).sum())
        ok &= checks.check(f"K4 {label} flags differ", diff, 0)
        text += (f", flags: {int((ref[2] == 0).sum())} of {ref[2].numel()} rows flagged inexact, "
                 f"{diff} differ from the plain version's")
    say(f"  K4 {label}: {text} {'ok' if ok and dead_ok and same else 'FAIL'}")
    return got, ref


def check_fa2_surface(torch, checks, rows):
    """ALiBi in K4, K9 and K10, dbias (K9's dS), return_softmax and
    clamped_verify (K4) against their plain versions on the card (rows "K4
    surface", "K9 surface", "K10 surface"): ALIBI_POINTS (each kernel
    launched twice, bitwise), the main one timed beside SDPA with ALiBi
    materialised as a float mask (forward and backward, the same function;
    the backward's device time by torch.profiler); DBIAS_POINTS (K9 with
    dS beside K9 with the same bias without it, K10, SDPA's backward with
    the float mask requiring grad); return_softmax at the 8B prefill shape
    (B=1, S=2048, causal, rope) in both modes, with and without dropout 0.1:
    rows of P summing to 1 without dropout, P @ V recomposing out, the
    entries above the diagonal exactly 0; clamped_verify with a bias and q
    x32 (some rows past 80): the flags as the plain version's."""
    from flash_attn_tpu_torch.ops import flash_fwd as ff
    from flash_attn_tpu_torch.ops.alibi import alibi_slopes

    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(SEED + 80)
    drop = ff.Dropout(DROP_RATE, DROP_SEED)
    worst = {"K4": 0.0, "K9": 0.0, "K10": 0.0}
    k4, k9, k10 = {}, {}, {}
    for key, B, Sq, Sk, H, Hk, D, causal, rope, mk, dropout in ALIBI_POINTS:
        q, k, v, dout, cos, sin, masks = _surface_inputs(torch, g, B, Sq, Sk, H, Hk, D, rope, mk)
        slopes = torch.from_numpy(alibi_slopes(H)).cuda()
        dr = drop if dropout else None
        label = (_opt_label(B, Sq, Sk, H, Hk, D, causal, masks, None, dr,
                            "packed documents" if masks is not None else "")
                 + (", rope" if cos is not None else "") + ", ALiBi")
        scale = D ** -0.5
        args = (q, k, v, causal, scale, cos, sin, False, masks, None, None, None, dr)
        (out, lse), _ = _k4_surface_case(torch, checks, worst, label, args, dict(alibi=slopes))
        delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        bargs = (q, k, v, dout, lse, delta, causal, scale, cos, sin, None, None, masks, None, dr)
        tail = (k, v, dout, lse, delta, causal, scale, None, None, masks, None, dr)
        bw = {"K9": 0.0, "K10": 0.0}
        dq, rq, _, _, res = _bwd_case(torch, checks, bw, label, bargs, tail, causal,
                                      kw=dict(alibi=slopes))
        say(f"  K9 {label}: {res['K9']}")
        say(f"  K10 {label}: {res['K10']}")
        worst["K9"], worst["K10"] = max(worst["K9"], bw["K9"]), max(worst["K10"], bw["K10"])
        if key in ("", "gpt2"):
            t4, t9, t10 = _alibi_times(torch, args, bargs, rq, tail, slopes, dout)
            k4[key], k9[key], k10[key] = t4, t9, t10
        del q, k, v, dout, out, lse, delta, dq, rq, args, bargs, tail
        torch.cuda.empty_cache()
    dbias = _check_dbias(torch, checks, worst, g, drop)
    probs = _check_probs(torch, checks, worst, g, drop)
    verify = _check_verify(torch, checks, worst, g)
    for key, name, ref, main, parts in (
            ("K4 surface", "flash_fwd with ALiBi (also return_softmax and clamped_verify)",
             "flash_fwd.py:221", k4[""], dict(gpt2=k4["gpt2"], probs=probs, verify=verify)),
            ("K9 surface", "flash_bwd dq pass with ALiBi (also dS for dbias)",
             "flash_bwd.py:127", k9[""], dict(gpt2=k9["gpt2"], dbias=dbias["K9"])),
            ("K10 surface", "flash_bwd dk/dv pass with ALiBi (beside K9's dS)",
             "flash_bwd.py:194", k10[""], dict(gpt2=k10["gpt2"], dbias=dbias["K10"]))):
        rows[key] = dict(
            name=f"{name} (B=1, S=2048, H=32, Hk=8, D=128, causal, rope, alibi_slopes(32))",
            source=f"flash_attn_tpu_torch/csrc/{ref.split('.')[0]}.cu",
            replaces=f"flash_attn_tpu/ops/{ref}", max_abs_err=worst[key.split()[0]], **main,
            **parts)
    say(f"  FA2 surface: {time.perf_counter() - t0:.2f}s")


def _alibi_times(torch, args, bargs, rq, tail, slopes, dout):
    """The ALiBi point's times: K4, K9 and K10 (CUDA events), the plain
    versions', SDPA's forward and backward with ALiBi as a float mask (the
    same function; the backward's device time by torch.profiler, its
    backend named), and the bounds (K4: q, k, v, out, lse against 4 D
    flops a live pair; K9: 3 products and dq in fp32; K10: 4 and dk, dv per
    query head in fp32)."""
    import torch.nn.functional as F

    from flash_attn_tpu_torch.ops import flash_bwd as fb
    from flash_attn_tpu_torch.ops import flash_fwd as ff
    from flash_attn_tpu_torch.ops.rope import rope_rotate

    q, k, v, causal, scale, cos, sin = args[:7]
    B, Sq, H, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    kw = dict(alibi=slopes)
    ms4 = cuda_ms(torch, lambda: ff.flash_fwd_cuda(*args, **kw))
    ms9 = cuda_ms(torch, lambda: fb.flash_bwd_dq_cuda(*bargs, **kw))
    ms10 = cuda_ms(torch, lambda: fb.flash_bwd_dkv_cuda(rq, *tail, **kw))
    plain4 = cuda_ms(torch, lambda: fwd_plain(args, **kw), iters=1, warmup=1)
    plain9 = cuda_ms(torch, lambda: bwd_plain(bargs, **kw), iters=1, warmup=1)
    qt = (q if cos is None else rope_rotate(q, cos, sin)).transpose(1, 2).contiguous()
    kt, vt = (x.transpose(1, 2).contiguous() for x in (k, v))
    fm = _alibi_mask(torch, slopes, Sq, Sk, causal)
    sdpa4 = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=fm, scale=scale, enable_gqa=True), iters=5)
    qt.requires_grad_(True)
    kt.requires_grad_(True)
    vt.requires_grad_(True)
    o = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=fm, scale=scale, enable_gqa=True)
    do_t = dout.transpose(1, 2).contiguous()
    sdpa_bwd, backend, names = sdpa_bwd_device_ms(
        torch, lambda: torch.autograd.grad(o, (qt, kt, vt), do_t, retain_graph=True), calls=3)
    del qt, kt, vt, o, fm, do_t
    pairs = B * int(ff.live_pairs(None, causal, Sq, Sk, "cuda").sum())
    kv_bytes = 2 * B * Sk * Hk * D * 2
    b4 = bound(2 * 2 * B * Sq * H * D + kv_bytes + B * H * Sq * 4 + H * 4, 4 * D * H * pairs)
    ins = 2 * (2 * B * Sq * H * D) + kv_bytes + B * H * Sq * 8 + H * 4
    b9 = bound(ins + B * Sq * H * D * 4, 3 * 2 * D * H * pairs)
    b10 = bound(ins + 2 * B * H * Sk * D * 4, 4 * 2 * D * H * pairs)
    sd = "not measured" if sdpa_bwd is None else f"{sdpa_bwd:.4f}"
    say(f"    K4 {ms4:.4f} ms ({4 * D * H * pairs / ms4 / 1e9:.1f} TFLOP/s), plain {plain4:.4f}, "
        f"SDPA with ALiBi as a float mask {sdpa4:.4f}, bound {b4[0]:.4f} ({b4[1]}); K9 "
        f"{ms9:.4f} ms, bound {b9[0]:.4f} ({b9[1]}); K10 {ms10:.4f} ms, bound {b10[0]:.4f} "
        f"({b10[1]}); plain (both passes) {plain9:.4f}; SDPA's backward with the float mask, "
        f"device time {sd} (backend {backend}: {', '.join(names)[:160]})")
    return (dict(ms=ms4, plain_ms=plain4, bound_ms=b4[0], bound_by=b4[1], library_ms=sdpa4),
            dict(ms=ms9, plain_ms=plain9, bound_ms=b9[0], bound_by=b9[1], library_ms=sdpa_bwd,
                 library_backend=backend),
            dict(ms=ms10, plain_ms=plain9, bound_ms=b10[0], bound_by=b10[1],
                 library_ms=sdpa_bwd, library_backend=backend))


def _check_dbias(torch, checks, worst, g, drop):
    """DBIAS_POINTS at 8B widths (B=2, S=2048, H=32, Hk=8, D=128, causal):
    K9 with dS and K10 (the bias's kOpt path) launched twice against the
    plain version (dq, dS, dk, dv rows), dbias (dS summed over the bias's
    broadcast axes) against the plain dS's; the main point timed: K9 with
    dS (the wrapper's zero-fill included) beside K9 with the same bias
    without it, K10, the plain version, SDPA's backward with the float
    mask requiring grad (device time; its backend), the bounds (the bias
    read once at the causal pairs; K9 with dS: the inputs, dq and the
    whole fp32 dS written once)."""
    from flash_attn_tpu_torch.ops import flash_bwd as fb
    from flash_attn_tpu_torch.ops import flash_fwd as ff

    B, S, H, Hk, D = 2, 2048, 32, 8, 128
    scale = D ** -0.5
    out9, out10 = {}, {}
    for key, shape, dropout in DBIAS_POINTS:
        q, k, v, dout, _, _, _ = _surface_inputs(torch, g, B, S, S, H, Hk, D, False, None)
        bias = torch.randn(shape, generator=g, device="cuda")
        b4 = ff.bias4(bias, B, H, S, S)
        dr = drop if dropout else None
        out, lse = ff.flash_fwd_cuda(q, k, v, True, scale, None, None, False, None, None, None,
                                     b4, dr)
        delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        bargs = (q, k, v, dout, lse, delta, True, scale, None, None, None, None, None, b4, dr)
        tail = (k, v, dout, lse, delta, True, scale, None, None, None, b4, dr)
        label = _opt_label(B, S, S, H, Hk, D, True, None, bias, dr) + ", dS (dbias)"
        bw = {"K9": 0.0, "K10": 0.0}
        _, rq, _, _, res = _bwd_case(torch, checks, bw, label, bargs, tail, True,
                                     kw=dict(want_ds=True))
        worst["K9"], worst["K10"] = max(worst["K9"], bw["K9"]), max(worst["K10"], bw["K10"])
        ds = fb.flash_bwd_dq_cuda(*bargs, want_ds=True)[2]
        dbias = fb._reduce_to_shape(ds, shape)
        del ds
        rds = bwd_plain(bargs, want_ds=True)[3]
        rdbias = fb._reduce_to_shape(rds, shape)
        del rds
        err, share = row_err(dbias, rdbias, floor=ds_floor(torch, rdbias, True))
        checks.check(f"dbias {label}", share, 1.0)
        say(f"  K9 {label}: {res['K9']}; dbias {list(shape)} max_abs_err {err:.3e} "
            f"({share:.3f} of its row's tol) {'ok' if share <= 1.0 else 'FAIL'}")
        say(f"  K10 {label}: {res['K10']}")
        if key == "":
            ms9 = cuda_ms(torch, lambda: fb.flash_bwd_dq_cuda(*bargs, want_ds=True))
            ms9_nods = cuda_ms(torch, lambda: fb.flash_bwd_dq_cuda(*bargs))
            ms10 = cuda_ms(torch, lambda: fb.flash_bwd_dkv_cuda(rq, *tail))
            plain_ms = cuda_ms(torch, lambda: bwd_plain(bargs, want_ds=True), iters=1, warmup=1)
            lib_ms, backend = _sdpa_dbias_ms(torch, q, k, v, dout, b4, scale)
            live = ff.live_pairs(None, True, S, S, "cuda")
            pairs = B * int(live.sum())
            gemm = 2 * D * H * pairs
            ins = ((2 * B * S * H * D + 2 * B * S * Hk * D) * 2 + B * H * S * 8
                   + _bias_bytes(torch, b4, live)[0])
            b9 = bound(ins + B * S * H * D * 4 + B * H * S * S * 4, 3 * gemm)
            b10 = bound(ins + 2 * B * H * S * D * 4, 4 * gemm)
            lib = "not measured" if lib_ms is None else f"{lib_ms:.4f}"
            say(f"    K9 with dS {ms9:.4f} ms (the zero-filled buffer included), without "
                f"{ms9_nods:.4f} (dS costs {ms9 - ms9_nods:.4f}), bound {b9[0]:.4f} ({b9[1]}: "
                f"the {B * H * S * S * 4 / 2 ** 30:.2f} GiB dS written once); K10 {ms10:.4f}, "
                f"bound {b10[0]:.4f} ({b10[1]}); plain (both passes, dS) {plain_ms:.4f}; SDPA's "
                f"backward with the float mask requiring grad, device time {lib} "
                f"(backend {backend})")
            out9 = dict(ms=ms9, ms_without_ds=ms9_nods, plain_ms=plain_ms, bound_ms=b9[0],
                        bound_by=b9[1], library_ms=lib_ms, library_backend=backend)
            out10 = dict(ms=ms10, plain_ms=plain_ms, bound_ms=b10[0], bound_by=b10[1],
                         library_ms=lib_ms, library_backend=backend)
        del q, k, v, dout, bias, b4, out, lse, delta, bargs, tail, rq, dbias, rdbias
        torch.cuda.empty_cache()
    return {"K9": out9, "K10": out10}


def _sdpa_dbias_ms(torch, q, k, v, dout, b4, scale):
    """SDPA's backward with the bias (causal -inf above the diagonal) as a
    float mask that requires grad: (device time by torch.profiler or None,
    the backend, or the error's text where no backend takes it)."""
    import torch.nn.functional as F

    from flash_attn_tpu_torch.ops import flash_fwd as ff

    S = q.shape[1]
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True) for x in (q, k, v))
    base = b4[:, :1] if b4.stride(1) == 0 else b4
    base = base[:1] if base.stride(0) == 0 else base
    m = base.masked_fill(~ff.live_pairs(None, True, S, S, "cuda")[:, None], float("-inf"))
    m = m.contiguous().requires_grad_(True)
    do_t = dout.transpose(1, 2).contiguous()
    try:
        o = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=m, scale=scale, enable_gqa=True)
        ms, backend, _ = sdpa_bwd_device_ms(
            torch, lambda: torch.autograd.grad(o, (qt, kt, vt, m), do_t, retain_graph=True),
            calls=3)
    except RuntimeError as e:  # no backend computes the mask's gradient here
        ms, backend = None, f"none: {str(e).splitlines()[0][:120]}"
    return ms, backend


def _check_probs(torch, checks, worst, g, drop):
    """return_softmax at the 8B prefill shape (B=1, S=2048, H=32, Hk=8,
    D=128, causal, rope) in both modes, without dropout and with 0.1: K4's
    probabilities against the plain version's (_k4_surface_case); without
    dropout each live row sums to 1 (to 1e-4); P @ V recomposes out (each
    row to two bf16 ulps); the entries above the diagonal are exactly 0.
    The online point without dropout timed: the kernel (the zero-filled
    buffers included), the whole flash_fwd call with the renormalisation,
    the plain version, the bound (q, k, v, out, lse and the 512 MiB of P
    written once).  No single PyTorch call returns attention's
    probabilities."""
    from flash_attn_tpu_torch.ops import flash_fwd as ff

    B, S, H, Hk, D = 1, 2048, 32, 8, 128
    q, k, v, _, cos, sin, _ = _surface_inputs(torch, g, B, S, S, H, Hk, D, True, None)
    res = {}
    dead = ~ff.live_pairs(None, True, S, S, "cuda")[0]
    vf = v.float().repeat_interleave(H // Hk, dim=2)
    for clamped in (False, True):
        for dr in (None, drop):
            mode = "clamped" if clamped else "online"
            args = (q, k, v, True, D ** -0.5, cos, sin, clamped, None, None, None, None, dr)
            label = (f"B={B}, S={S}, H={H}, Hk={Hk}, D={D}, causal, rope, {mode}"
                     + (f", dropout {dr.rate}" if dr else "") + ", return_softmax")
            (out, lse, p), _ = _k4_surface_case(torch, checks, worst, label, args,
                                                dict(probs=True))
            zeros = bool((p[:, :, dead] == 0).all())
            if not zeros:
                checks.failed.append(f"K4 {label}: P above the diagonal is not 0")
            _, share = row_err(out, torch.einsum("bhqk,bkhd->bqhd", p, vf))
            ok = checks.check(f"K4 {label} P @ V", share, 1.0)
            line = (f"    P above the diagonal exactly 0 {zeros}; P @ V against out "
                    f"{share:.3f} of its row's tol")
            if dr is None:
                sums = float((p.sum(-1) - 1.0).abs().max())
                ok &= checks.check(f"K4 {label} row sums", sums, 1e-4)
                line += f"; rows sum to 1 within {sums:.2e} (tol 1e-4)"
            say(line + f" {'ok' if ok and zeros else 'FAIL'}")
            del out, lse, p
            if not clamped and dr is None:
                ms = cuda_ms(torch, lambda: ff.flash_fwd_cuda(*args, probs=True))
                called = cuda_ms(torch, lambda: ff.flash_fwd(
                    q, k, v, causal=True, rope_cos=cos, rope_sin=sin, return_softmax=True))
                plain = cuda_ms(torch, lambda: fwd_plain(args, probs=True), iters=1, warmup=1)
                pairs = int((~dead).sum())
                b = bound(2 * (2 * B * S * H * D) + 2 * 2 * B * S * Hk * D + B * H * S * 4
                          + B * H * S * S * 4, 4 * D * H * pairs)
                say(f"    K4 with return_softmax {ms:.4f} ms (the zero-filled buffers "
                    f"included), as called with the renormalisation {called:.4f}, plain "
                    f"{plain:.4f}, bound {b[0]:.4f} ({b[1]}: P's {B * H * S * S * 4 / 2 ** 20:.0f} "
                    "MiB written once)")
                res = dict(ms=ms, as_called_ms=called, plain_ms=plain, bound_ms=b[0],
                           bound_by=b[1], library_ms=None)
            torch.cuda.empty_cache()
    del q, k, v, vf, cos, sin, dead
    torch.cuda.empty_cache()
    return res


def _check_verify(torch, checks, worst, g):
    """clamped_verify and auto at the 8B prefill shape (B=1, S=2048, H=32,
    Hk=8, D=128, causal, rope): in range, auto is bitwise the clamped call
    with one K4 launch; with q x32 (base-2 scores past 80) bitwise the
    online call with two; with a [S, S] bias and q x32 the verify
    instance's flags against the plain version's (_k4_surface_case), and
    auto bitwise the online call with the bias (two launches, one of them
    verify).  Timed: the verify instance beside the clamped call with the
    same bias (what tracking the max costs), auto in range."""
    from flash_attn_tpu_torch.ops import flash_fwd as ff

    B, S, H, Hk, D = 1, 2048, 32, 8, 128
    q, k, v, _, cos, sin, _ = _surface_inputs(torch, g, B, S, S, H, Hk, D, True, None)
    bias = torch.randn((S, S), generator=g, device="cuda")
    res = {}

    def call(qq, mode, b=None):
        before = _read_counts()
        o = ff.flash_fwd(qq, k, v, causal=True, rope_cos=cos, rope_sin=sin, bias=b,
                         softmax_mode=mode)
        after = _read_counts()
        return o, (after["K4"] - before["K4"], after["K4 verify"] - before["K4 verify"])

    for name, qq, b, other, want in (("in range", q, None, "clamped", (1, 0)),
                                     ("q x32", q * 32, None, "online", (2, 0)),
                                     ("in range, a bias", q, bias, "clamped", (1, 1)),
                                     ("q x32, a bias", q * 32, bias, "online", (2, 1))):
        (oa, la), n = call(qq, "auto", b)
        (oo, lo), _ = call(qq, other, b)
        same = torch.equal(oa, oo) and torch.equal(la, lo)
        ok = same and n == want
        if not ok:
            checks.failed.append(f"auto {name}: bitwise the {other} call {same}, launches "
                                 f"(K4, verify) {n}, want {want}")
        say(f"  auto, {name} (B={B}, S={S}, H={H}, Hk={Hk}, D={D}, causal, rope): bitwise the "
            f"{other} call {same}; K4 launches {n[0]}, verify {n[1]} (want {want}) "
            f"{'ok' if ok else 'FAIL'}")
    args = (q * 32, k, v, True, D ** -0.5, cos, sin, True, None, None, None,
            ff.bias4(bias, B, H, S, S), None)
    label = f"B={B}, S={S}, H={H}, Hk={Hk}, D={D}, causal, rope, q x32, bias [{S}, {S}], verify"
    _k4_surface_case(torch, checks, worst, label, args, dict(verify=True))
    ms_v = cuda_ms(torch, lambda: ff.flash_fwd_cuda(*args, verify=True))
    ms_c = cuda_ms(torch, lambda: ff.flash_fwd_cuda(*args))
    ms_auto = cuda_ms(torch, lambda: call(q, "auto"))
    ms_cl = cuda_ms(torch, lambda: call(q, "clamped"))
    say(f"    verify {ms_v:.4f} ms beside the clamped call with the same bias {ms_c:.4f}; auto "
        f"in range as called {ms_auto:.4f} (one host read) beside clamped {ms_cl:.4f}")
    res = dict(ms=ms_v, clamped_ms=ms_c, auto_ms=ms_auto, auto_clamped_ms=ms_cl)
    del q, k, v, bias, args
    torch.cuda.empty_cache()
    return res


def _plain_grads(torch, bargs, kw, Hk):
    """(dq, dk, dv, and with ``want_ds`` dS) from the plain version on the
    card, dk and dv summed over each GQA group as flash_bwd sums them."""
    ref = bwd_plain(bargs, **kw)
    B, H, Sk, D = ref[1].shape
    group = lambda x: x.reshape(B, Hk, H // Hk, Sk, D).sum(2).transpose(1, 2)  # noqa: E731
    return (ref[0], group(ref[1]), group(ref[2]), *ref[3:])


def _surface_run(torch, checks, label, fn, want):
    """``fn()`` with every launch count zeroed just before and read just
    after, held to ``want`` exactly; returns (fn's result, counts)."""
    _reset_counts()
    res = fn()
    torch.cuda.synchronize()
    counts = _read_counts()
    _launches_exact(checks, label, counts, want)
    return res, counts


def phase_fa2_surface(torch, checks, smi):
    """Phase 22: the FA2 surface through the public entry points at the
    kernels' phase-2 widths: flash_attention with ALiBi forward and
    backward under autograd (Llama-3-8B's attention widths, B=1, S=2048,
    causal, rope, alibi_slopes(32)), a [1, 32, 2048, 2048] mask that
    requires grad (B=2), return_softmax and softmax_mode "auto" in range and
    with q x32; flash_attention_varlen at GPT-2's widths (8 sequences in
    4096, causal in each) with return_softmax and a [4096, 4096] mask that
    requires grad; the ring (4 ranks of S_loc 1024 on one card, causal,
    contiguous and striped) with a [1, 32, 4096, 4096] bias that requires
    grad, held to the single call (out rows, every gradient to
    TRAIN_GRAD_TOL of its norm).  Each result against the plain versions
    on the card (out rows to two bf16 ulps, gradients and the mask's to
    TRAIN_GRAD_TOL of their norm), each run's launches exact (ALiBi, probs,
    verify and dS counted apart)."""
    from flash_attn_tpu_torch import alibi_slopes
    from flash_attn_tpu_torch.ops import flash_bwd as fb
    from flash_attn_tpu_torch.ops import flash_fwd as ff
    from flash_attn_tpu_torch.ops.attention import flash_attention, flash_attention_varlen
    from flash_attn_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from flash_attn_tpu_torch.parallel.ring import (
        make_ring_attention,
        stripe_sequence,
        unstripe_sequence,
    )

    t0 = time.perf_counter()
    say(f"[phase 22 the FA2 surface] through flash_attention, flash_attention_varlen and the "
        f"ring ({smi})")
    g = torch.Generator(device="cuda").manual_seed(SEED + 82)
    total = {}

    def add(counts):
        for key, n in counts.items():
            total[key] = total.get(key, 0) + n

    def grads_err(got, ref, names):
        errs = [_rel_norm(a, b) for a, b in zip(got, ref)]
        ok = all(checks.check(f"phase 22 {n} (relative norm)", e, TRAIN_GRAD_TOL)
                 for n, e in zip(names, errs))
        return ok, ", ".join(f"{n} {e:.3e}" for n, e in zip(names, errs))

    # ALiBi, forward and backward under autograd
    B, S, H, Hk, D = 1, 2048, 32, 8, 128
    q, k, v, dout, cos, sin, _ = _surface_inputs(torch, g, B, S, S, H, Hk, D, True, None)
    slopes = torch.from_numpy(alibi_slopes(H)).cuda()
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]

    def alibi_call():
        out = flash_attention(*leaves, causal=True, rope_cos=cos, rope_sin=sin,
                              alibi_slopes=alibi_slopes(H))
        return out.detach(), torch.autograd.grad(out, leaves, dout)

    want = {"K4": 1, "K4 alibi": 1, "K9": 1, "K9 alibi": 1, "K10": 1, "K10 alibi": 1}
    (out, grads), counts = _surface_run(torch, checks, "phase 22 ALiBi", alibi_call, want)
    add(counts)
    args = (q, k, v, True, D ** -0.5, cos, sin, False, None, None, None, None, None)
    rout, rlse = fwd_plain(args, alibi=slopes)
    delta = (dout.float() * rout.float()).sum(-1).transpose(1, 2).contiguous()
    bargs = (q, k, v, dout, rlse, delta, True, D ** -0.5, cos, sin, None, None, None, None,
             None)
    _, share = row_err(out, rout)
    ok = checks.check("phase 22 ALiBi out", share, 1.0)
    gok, gtext = grads_err(grads, _plain_grads(torch, bargs, dict(alibi=slopes), Hk),
                           ("dq", "dk", "dv"))
    say(f"  flash_attention with ALiBi (B={B}, S={S}, H={H}, Hk={Hk}, D={D}, causal, rope): out "
        f"{share:.3f} of its row's tol, gradients' relative norm err {gtext} "
        f"{'ok' if ok and gok else 'FAIL'} | launches {counts_of(counts, want)}")
    del out, grads, rout, rlse, delta, bargs, leaves

    # return_softmax and auto
    with torch.no_grad():
        want = {"K4": 1, "K4 probs": 1}
        (o, lse, p), counts = _surface_run(torch, checks, "phase 22 return_softmax", lambda: (
            flash_attention(q, k, v, causal=True, rope_cos=cos, rope_sin=sin,
                            return_softmax=True)), want)
        add(counts)
        ref = fwd_plain(args, probs=True)
        rp = ff.softmax_probs(ref[2], ref[3], ref[1], S)
        _, share = row_err(p, rp, rel=2.0 ** -10, floor=1e-7)
        ok = checks.check("phase 22 return_softmax P", share, 1.0)
        say(f"  flash_attention(return_softmax=True): P {share:.3f} of its row's tol "
            f"{'ok' if ok else 'FAIL'} | launches {counts_of(counts, want)}")
        del o, lse, p, ref, rp
        mask = torch.randn((S, S), generator=g, device="cuda")
        for name, qq, m, other, want in (
                ("in range", q, None, "clamped", {"K4": 1, "K4 verify": 0}),
                ("q x32", q * 32, None, "online", {"K4": 2, "K4 verify": 0}),
                ("in range, a mask", q, mask, "clamped", {"K4": 1, "K4 verify": 1}),
                ("q x32, a mask", q * 32, mask, "online", {"K4": 2, "K4 verify": 1})):
            oa, counts = _surface_run(torch, checks, f"phase 22 auto {name}", lambda: (
                flash_attention(qq, k, v, causal=True, rope_cos=cos, rope_sin=sin, mask=m,
                                softmax_mode="auto")), want)
            add(counts)
            oo = flash_attention(qq, k, v, causal=True, rope_cos=cos, rope_sin=sin, mask=m,
                                 softmax_mode=other)
            same = torch.equal(oa, oo)
            if not same:
                checks.failed.append(f"phase 22 auto {name}: not bitwise the {other} call")
            say(f"  flash_attention(softmax_mode='auto'), {name}: bitwise the {other} call "
                f"{same} | launches {counts_of(counts, want)}")
    del q, k, v, dout, cos, sin, args, mask
    torch.cuda.empty_cache()

    # a mask that requires grad (dbias), B=2
    B = 2
    q, k, v, dout, _, _, _ = _surface_inputs(torch, g, B, S, S, H, Hk, D, False, None)
    bias = torch.randn((1, H, S, S), generator=g, device="cuda")
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v, bias)]

    def dbias_call():
        out = flash_attention(*leaves[:3], causal=True, mask=leaves[3])
        return out.detach(), torch.autograd.grad(out, leaves, dout)

    want = {"K4": 1, "K4 extra": 1, "K9": 1, "K9 ds": 1, "K10": 1}
    (out, grads), counts = _surface_run(torch, checks, "phase 22 dbias", dbias_call, want)
    add(counts)
    b4 = ff.bias4(bias, B, H, S, S)
    args = (q, k, v, True, D ** -0.5, None, None, False, None, None, None, b4, None)
    rout, rlse = fwd_plain(args)
    delta = (dout.float() * rout.float()).sum(-1).transpose(1, 2).contiguous()
    bargs = (q, k, v, dout, rlse, delta, True, D ** -0.5, None, None, None, None, None, b4, None)
    ref = _plain_grads(torch, bargs, dict(want_ds=True), Hk)
    ref = (*ref[:3], fb._reduce_to_shape(ref[3], bias.shape))
    _, share = row_err(out, rout)
    ok = checks.check("phase 22 dbias out", share, 1.0)
    gok, gtext = grads_err(grads, ref, ("dq", "dk", "dv", "dmask"))
    say(f"  flash_attention with a [1, {H}, {S}, {S}] mask that requires grad (B={B}, causal): "
        f"out {share:.3f} of its row's tol, gradients' relative norm err {gtext} "
        f"{'ok' if ok and gok else 'FAIL'} | launches {counts_of(counts, want)}")
    del q, k, v, dout, bias, leaves, out, grads, b4, args, rout, rlse, delta, bargs, ref
    torch.cuda.empty_cache()

    # varlen at GPT-2's widths: return_softmax and a mask that requires grad
    T_, H, Hk, D = sum(GPT2_LENS), 12, 12, 64
    q, k, v, dout, _, _, _ = _surface_inputs(torch, g, 1, T_, T_, H, Hk, D, False, None)
    q, k, v, dout = q[0], k[0], v[0], dout[0]
    cu = _cu(torch, GPT2_LENS)
    mask = torch.randn((T_, T_), generator=g, device="cuda")
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v, mask)]

    def varlen_call():
        with torch.no_grad():
            probs = flash_attention_varlen(q, k, v, cu, cu, causal=True, mask=mask,
                                           return_softmax=True)
        out = flash_attention_varlen(*leaves[:3], cu, cu, causal=True, mask=leaves[3])
        return probs, out.detach(), torch.autograd.grad(out, leaves, dout)

    want = {"K4": 2, "K4 probs": 1, "K4 extra": 2, "K9": 1, "K9 ds": 1, "K10": 1}
    (probs, out, grads), counts = _surface_run(torch, checks, "phase 22 varlen", varlen_call,
                                               want)
    add(counts)
    masks = _varlen_masks(torch, GPT2_LENS)
    b4 = ff.bias4(mask[None, None], 1, H, T_, T_)
    args = (q[None], k[None], v[None], False, D ** -0.5, None, None, False, masks, None, None,
            b4, None)
    ref = fwd_plain(args, probs=True)
    rp = ff.softmax_probs(ref[2], ref[3], ref[1], T_)[0]
    delta = (dout[None].float() * ref[0].float()).sum(-1).transpose(1, 2).contiguous()
    bargs = (q[None], k[None], v[None], dout[None], ref[1], delta, False, D ** -0.5, None, None,
             None, None, masks, b4, None)
    rg = _plain_grads(torch, bargs, dict(want_ds=True), Hk)
    rg = (rg[0][0], rg[1][0], rg[2][0], fb._reduce_to_shape(rg[3], (T_, T_)))
    _, share = row_err(out, ref[0][0])
    _, pshare = row_err(probs[2], rp, rel=2.0 ** -10, floor=1e-7)
    ok = checks.check("phase 22 varlen out", share, 1.0) & checks.check(
        "phase 22 varlen P", pshare, 1.0)
    gok, gtext = grads_err(grads, rg, ("dq", "dk", "dv", "dmask"))
    say(f"  flash_attention_varlen (8 sequences in {T_}, H=Hk={H}, D={D}, causal in each, a "
        f"[{T_}, {T_}] mask): P {pshare:.3f} and out {share:.3f} of their rows' tol, gradients' "
        f"relative norm err {gtext} {'ok' if ok and gok else 'FAIL'} | launches "
        f"{counts_of(counts, want)}")
    del q, k, v, dout, mask, leaves, probs, out, grads, b4, args, ref, rp, delta, bargs, rg
    torch.cuda.empty_cache()

    # the ring with a bias that requires grad, against the single call
    n, S, H, Hk, D = SP_N, 4096, 32, 8, 128
    mesh = make_mesh(MeshConfig(sp=n), devices=["cuda:0"] * n)
    q, k, v, dout, _, _, _ = _surface_inputs(torch, g, 1, S, S, H, Hk, D, False, None)
    bias = torch.randn((1, H, S, S), generator=g, device="cuda")
    xs = [x.clone().requires_grad_(True) for x in (q, k, v, bias)]
    single = flash_attention(*xs[:3], causal=True, mask=xs[3])
    ref = (single.detach(), torch.autograd.grad(single, xs, dout))
    del single
    ring = make_ring_attention(mesh, causal=True, has_bias=True)
    striped = make_ring_attention(mesh, causal=True, layout="striped", has_bias=True)

    def striped_call(q_, k_, v_, b_):
        st = [stripe_sequence(x, n) for x in (q_, k_, v_)]
        b_st = stripe_sequence(stripe_sequence(b_, n, axis=2), n, axis=3)
        return unstripe_sequence(striped(*st, b_st), n)

    for name, fn, steps in (("contiguous", ring, n * (n + 1) // 2), ("striped", striped_call,
                                                                      n * n)):
        want = {"K4": steps, "K9": steps, "K9 ds": steps, "K10": steps}
        counts, _, _ = _sp_run(torch, checks, f"phase 22 ring {name}, a [1, {H}, {S}, {S}] "
                               "bias that requires grad, against the single call", fn, xs, ref,
                               want, dout)
        add(counts)
    del q, k, v, dout, bias, xs, ref
    gc.collect()
    torch.cuda.empty_cache()
    total["K4 surface"] = total["K4 alibi"] + total["K4 probs"] + total["K4 verify"]
    total["K9 surface"] = total["K9 alibi"] + total["K9 ds"]
    total["K10 surface"] = total["K10 alibi"]
    keys = ("K4", "K4 alibi", "K4 probs", "K4 verify", "K4 extra", "K9", "K9 alibi", "K9 ds",
            "K10", "K10 alibi")
    say(f"  kernels {json.dumps({key: total.get(key, 0) for key in keys})}")
    say(f"[phase 22 the FA2 surface] {time.perf_counter() - t0:.2f}s")
    return {RUN_SURFACE: total}


def counts_of(counts, want):
    """The counts of ``want``'s keys, as printed beside a run."""
    return {key: counts[key] for key in want}


K11_N, K11_B, K11_H, K11_HK, K11_D, K11_SLOC = 4, 1, 32, 8, 128, 4096  # Llama-3-8B widths
# small K11 cases: (label, ranks, B, H, Hk, D, S_loc, block_q, causal,
# dtype, q multiplier): a ragged S_loc (not a multiple of block_q 128) at
# B=2, a group of one at head_dim 64, 8 ranks (slots reused over 8 steps),
# 1 rank (no push), and large logits: q x 8 puts them at ~+-40, where one
# TF32 pass (10 mantissa bits) errs ~0.02 in a logit and misses the fp32
# row rule tenfold; K11's three passes hold it
K11_SMALL = (("ragged S_loc=320 B=2", 4, 2, 32, 8, 128, 320, 64, True, "bfloat16", 1.0),
             ("G=1 d64", 4, 1, 12, 12, 64, 256, 128, False, "float32", 1.0),
             ("8 ranks", 8, 1, 8, 2, 128, 192, 64, True, "float32", 1.0),
             ("1 rank", 1, 1, 8, 8, 128, 256, 128, True, "bfloat16", 1.0),
             ("large logits, q x8", 4, 1, 8, 2, 128, 1024, 128, True, "float32", 8.0))


def _k11_inputs(torch, g, n, B, S_loc, H, Hk, D, dtype, q_mult=1.0):
    """Per-rank shards on cuda:0 (the ranks share the card); q times
    ``q_mult``."""
    dt = getattr(torch, dtype)

    def one(h, mult=1.0):
        return (torch.randn((B, S_loc, h, D), generator=g, device="cuda") * mult).to(dt)

    return ([one(H, q_mult) for _ in range(n)], [one(Hk) for _ in range(n)],
            [one(Hk) for _ in range(n)])


def k11_pairs(n, S_loc, causal) -> int:
    """Live (query, key) pairs of one (batch, head) over the ring: the
    global causal triangle or the full square."""
    S = n * S_loc
    return S * (S + 1) // 2 if causal else S * S


def _k11_case(torch, checks, label, qs, ks, vs, causal, block_q=128):
    """K11 through rdma_ring_attention against its plain version on the
    card: every output row within its tolerance (bf16 out: two bf16 ulps
    of the row's largest; fp32 out: 2^-12, the kernel and its plain version
    summing 16384 keys in another order, in 64-key tiles with an online
    softmax, and merging by exp and log a step), a second launch bitwise
    the first.  Returns (max |err|, the outputs)."""
    from flash_attn_tpu_torch.parallel import rdma_ring as rr

    D = qs[0].shape[-1]
    out = rr.rdma_ring_attention(qs, ks, vs, causal=causal, block_q=block_q)
    again = rr.rdma_ring_attention(qs, ks, vs, causal=causal, block_q=block_q)
    ref = rr.ring_attn_plain(qs, ks, vs, causal, D ** -0.5)
    torch.cuda.synchronize()
    rel = 2.0 ** -6 if qs[0].dtype == torch.bfloat16 else 2.0 ** -12
    err, share = row_err(torch.stack(out), torch.stack(ref), rel=rel)
    same = all(torch.equal(a, b) for a, b in zip(out, again))
    ok = checks.check(f"K11 {label}", share, 1.0)
    if not same:
        checks.failed.append(f"K11 {label}: two launches differ")
    say(f"  K11 {label}: max_abs_err {err:.3e} ({share:.3f} of its row's tol, rel {rel:g}), "
        f"bitwise repeat {'ok' if same else 'FAIL'} {'ok' if ok and same else 'FAIL'} | grid "
        f"{rr.ring_attn_cuda.grid}")
    return err


def check_k11(torch, checks, rows):
    """K11, the ring in one cooperative launch, at Llama-3-8B's attention
    widths over 4 ranks on the one card (S_loc 4096: 16384 tokens), causal
    and not, bf16 and fp32 in, against its plain version, repeated bitwise,
    timed (CUDA events, 3 calls: a call takes 0.02-0.2 s) beside the plain
    version, SDPA's memory-efficient backend on the gathered fp32 sequence
    (the same function: fp32 in, causal, KV heads repeated) and three
    bounds: three times the operations at the TF32 tensor-core peak (K11's
    three passes; the row's bound), the operations at the fp32 CUDA-core
    peak and at the bf16 tensor-core peak; then K11_SMALL."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from flash_attn_tpu_torch.parallel import rdma_ring as rr

    g = torch.Generator(device="cuda").manual_seed(SEED + 80)
    n, B, H, Hk, D, S_loc = K11_N, K11_B, K11_H, K11_HK, K11_D, K11_SLOC
    worst, row = 0.0, {}
    for dtype in ("float32", "bfloat16"):
        qs, ks, vs = _k11_inputs(torch, g, n, B, S_loc, H, Hk, D, dtype)
        for causal in (True, False):
            label = f"{dtype} {'causal' if causal else 'non-causal'}"
            worst = max(worst, _k11_case(torch, checks, label, qs, ks, vs, causal))
            if dtype != "float32":
                continue
            scale = D ** -0.5
            ms = cuda_ms(torch, lambda: rr.ring_attn_cuda(qs, ks, vs, causal, scale), iters=3,
                         warmup=1)
            plain_ms = cuda_ms(torch, lambda: rr.ring_attn_plain(qs, ks, vs, causal, scale),
                               iters=1, warmup=0)
            qg = torch.cat(qs, dim=1).transpose(1, 2).contiguous()
            kg, vg = (torch.cat(x, dim=1).repeat_interleave(H // Hk, dim=2).transpose(1, 2)
                      .contiguous() for x in (ks, vs))
            with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                lib_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                    qg, kg, vg, is_causal=causal), iters=3, warmup=1)
            del qg, kg, vg
            flops = 4 * D * B * H * k11_pairs(n, S_loc, causal)
            nbytes = 4 * n * B * S_loc * D * (2 * H + 2 * Hk)
            b_ms, b_by = bound(nbytes, 3 * flops, TF32_FLOPS_PER_S)
            f32_ms = flops / F32_FLOPS_PER_S * 1e3
            bf16_ms = flops / BF16_FLOPS_PER_S * 1e3
            say(f"  K11 {label} time: {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s of fp32 "
                f"products on {k11_pairs(n, S_loc, causal)} live pairs a head), plain "
                f"{plain_ms:.4f}, library (SDPA efficient, fp32, gathered) {lib_ms:.4f}, bound "
                f"{b_ms:.4f} ({b_by}: three TF32 passes at {TF32_FLOPS_PER_S / 1e12:g} "
                f"TFLOP/s), {f32_ms:.4f} at the fp32 CUDA-core peak, {bf16_ms:.4f} at the bf16 "
                f"tensor-core peak; ours / library {ms / lib_ms:.3f}")
            point = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                         bound_by=b_by, bound_f32_ms=f32_ms, bound_bf16_ms=bf16_ms)
            if causal:
                row.update(point)
            else:
                row["non_causal"] = point
        del qs, ks, vs
        torch.cuda.empty_cache()
    for label, n2, B2, H2, Hk2, D2, S2, bq, causal, dtype, q_mult in K11_SMALL:
        qs, ks, vs = _k11_inputs(torch, g, n2, B2, S2, H2, Hk2, D2, dtype, q_mult)
        worst = max(worst, _k11_case(torch, checks, label, qs, ks, vs, causal, bq))
    rows["K11"] = dict(name=f"ring_attn (n={n} ranks on one card, B={B}, S_loc={S_loc}, H={H}, "
                            f"Hk={Hk}, D={D}, fp32 in, causal)",
                       source="flash_attn_tpu_torch/csrc/ring_attn.cu",
                       replaces="flash_attn_tpu/parallel/rdma_ring.py:51",
                       max_abs_err=worst, **row)


def phase_kernels(torch, checks):
    t0 = time.perf_counter()
    rows = {}
    check_k3(torch, checks, rows)
    check_k1(torch, checks, rows)
    check_k1m(torch, checks, rows)
    check_k1_shard(torch, checks, rows)
    torch.cuda.empty_cache()
    check_k1c(torch, checks, rows)
    check_k1b(torch, checks, rows)
    check_g3(torch, checks)
    torch.cuda.empty_cache()
    check_k2(torch, checks, rows)
    check_k4(torch, checks, rows)
    check_k4_shapes(torch, checks)
    check_k4_masked(torch, checks, rows)
    torch.cuda.empty_cache()
    check_k4_gemma(torch, checks, rows)
    check_k1_gemma(torch, checks, rows)
    check_k3_gemma(torch, checks, rows)
    torch.cuda.empty_cache()
    check_k4_gemma(torch, checks, rows, "K4 27B", H=32, Hk=16, D=128, scale=GEMMA27_SCALE,
                   seed=SEED + 33)
    check_k1_gemma(torch, checks, rows, "K1 27B", H=32, Hk=16, D=128, scale=GEMMA27_SCALE,
                   kvs=("fp8",), k1m_key=None, seed=SEED + 34)
    check_k3_gemma(torch, checks, rows, GEMMA27_GEMMS, "gemma27b", "Gemma-2-27B", SEED + 35)
    torch.cuda.empty_cache()
    check_k4_gpt2(torch, checks, rows)
    check_decode_gpt2(torch, checks, rows)
    check_k8_gpt2(torch, checks, rows)
    torch.cuda.empty_cache()
    check_qwen2(torch, checks, rows)
    torch.cuda.empty_cache()
    check_mistral(torch, checks, rows)
    torch.cuda.empty_cache()
    check_mistral_train(torch, checks, rows)
    torch.cuda.empty_cache()
    check_k9_k10(torch, checks, rows)
    torch.cuda.empty_cache()
    check_fa2_options(torch, checks, rows)
    torch.cuda.empty_cache()
    check_fa2_surface(torch, checks, rows)
    torch.cuda.empty_cache()
    check_k11(torch, checks, rows)
    torch.cuda.empty_cache()
    check_k8(torch, checks, rows)
    torch.cuda.empty_cache()
    for check in (check_k3g, check_k6, check_k5, check_k7, check_tp_slices):
        check(torch, checks, rows)
        torch.cuda.empty_cache()
    check_variants(torch, checks)
    torch.cuda.empty_cache()
    say(f"[phase 2 kernels vs plain] {'ok' if not checks.failed else 'FAIL'} | "
        f"{time.perf_counter() - t0:.2f}s")
    return rows


def _to(tree, device):
    """A params tree (dicts, lists, tuples, the weight dataclasses) with
    every tensor moved to ``device``."""
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    if isinstance(tree, tuple):
        return tuple(_to(v, device) for v in tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _to(getattr(tree, f.name), device) for f in dataclasses.fields(tree)})
    return tree.to(device) if hasattr(tree, "to") else tree


# (label, quantize, head_mode, fuse) of the card-vs-CPU runs
CARD_VS_CPU = (
    ("int8 weights", "int8", None, False),
    ("int4 g=128 + W8A8 head, fused", "int4", "w8a8", True),
    ("W4A8 g=128 + W8A8 head, fused", "w4a8", "w8a8", True),
    ("int8 weights + int8 head", "int8", "int8", False),
    ("int4 g=128 + int4 head, fused", "int4", "int4", True),
)


def card_vs_cpu(torch, checks, label, quantize, head_mode, fuse, base=None, width="8B",
                seed=SEED + 4):
    """2 layers at full 8B widths (or ``base``'s, named ``width``), fp8 KV:
    two prompts and four decode steps in lockstep on the card and on the
    CPU, fed the same tokens (the CPU's greedy choices).  The weights are
    made and quantized on the card and copied to the CPU."""
    import numpy as np

    from flash_attn_tpu_torch.models import llama

    t0 = time.perf_counter()
    cfg = dataclasses.replace(base or llama.LLAMA3_8B, num_layers=2)
    card = llama.init_params(cfg, seed=seed, device="cuda", quantize=quantize,
                             head_mode=head_mode, fuse=fuse)
    sides = {"cpu": _to(card, "cpu"), "cuda": card}
    caches = {d: llama.make_cache(cfg, 2, 256, mode="fp8", device=d) for d in sides}
    rng = np.random.default_rng(seed)
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
    # so only summation order differs; it can flip a bf16 (2^-8), an int8
    # activation (1/127 of a row's absmax) or an fp8 KV (2^-4) rounding,
    # which two layers carry into the logits
    tol = 5e-2 * float(ref.abs().max())
    ok = checks.check(f"card vs cpu logits, {label}", err, tol) and finite
    if not finite:
        checks.failed.append(f"card logits not finite, {label}")
    agree = int((got.argmax(-1) == ref.argmax(-1)).sum())
    say(f"[phase 3 card vs cpu, 2 layers at {width} widths, {label}, fp8 KV] logits "
        f"{tuple(got.shape)} finite={finite} max_abs_err {err:.3e} (tol {tol:.3e}, "
        f"max |logit| {float(ref.abs().max()):.3f}) {'ok' if ok else 'FAIL'} | greedy "
        f"agreement {agree}/{ref.shape[0]} | {time.perf_counter() - t0:.2f}s")
    del sides, caches, card
    torch.cuda.empty_cache()


def prefill_card_vs_cpu(torch, checks, base=None, width="8B", seed=SEED + 24,
                        lens=(300, 200, 57), chunk_len=700):
    """2 layers at full 8B widths (or ``base``'s, named ``width``), int8
    weights, the prefill paths on the
    card against the CPU: prefill_packed of three prompts (``lens``, 300 +
    200 + 57 tokens in the 1024 bucket), the logits of every real row;
    prefill_chunk of a ``chunk_len``-token (700) prompt in chunks of 256
    into slot 1 of an fp8 cache of 1024 positions, every chunk's real
    logits and the slot's cache after
    the last chunk (dequantized values and scales; the share of equal bytes
    is printed).  Each within the phase's 5 % of its largest reference; a
    cached value also within one e4m3 step of itself (1/8 of its
    magnitude), the rounding flip that a value summed in another order
    can take."""
    import numpy as np

    from flash_attn_tpu_torch.models import llama

    t0 = time.perf_counter()
    cfg = dataclasses.replace(base or llama.LLAMA3_8B, num_layers=2)
    card = llama.init_params(cfg, seed=seed, device="cuda", quantize="int8")
    sides = {"cpu": _to(card, "cpu"), "cuda": card}
    rng = np.random.default_rng(seed)
    off = sum(lens)
    toks = torch.zeros((1, 1024), dtype=torch.long)
    toks[0, :off] = torch.from_numpy(rng.integers(0, cfg.vocab_size, off))
    seg, pos = _packed_positions(torch, lens, 1024)
    got = {}
    for d, params in sides.items():
        logits, _ = llama.prefill_packed(params, toks.to(d), pos.to(d), seg.to(d), cfg)
        got[d] = logits[0, :off].float().cpu()
        del logits
    results = [("prefill_packed logits", got["cuda"], got["cpu"], False)]
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, chunk_len))
    caches = {d: llama.make_cache(cfg, 2, 1024, mode="fp8", device=d) for d in sides}
    got = {d: [] for d in sides}
    for start in range(0, chunk_len, 256):
        chunk = torch.zeros((1, 256), dtype=torch.long)
        n = min(256, chunk_len - start)
        chunk[0, :n] = prompt[start:start + n]
        for d, params in sides.items():
            logits, _ = llama.prefill_chunk(params, chunk.to(d), cfg, caches[d], 1, start)
            got[d].append(logits[0, :n].float().cpu())
            del logits
    results.append(("prefill_chunk logits", torch.cat(got["cuda"]), torch.cat(got["cpu"]),
                    False))
    same_bytes = []
    for layer in range(cfg.num_layers):
        for name, which in (("k", 0), ("v", 1)):
            ref = caches["cpu"].slot_kv_float(layer, 1, torch.float32)[which]
            mine = caches["cuda"].slot_kv_float(layer, 1, torch.float32)[which].cpu()
            results.append((f"prefill_chunk cache {name} layer {layer}", mine, ref, True))
            scales = caches["cpu"].k_scale if which == 0 else caches["cpu"].v_scale
            scales_card = caches["cuda"].k_scale if which == 0 else caches["cuda"].v_scale
            results.append((f"prefill_chunk cache {name}_scale layer {layer}",
                            scales_card[layer][1].cpu(), scales[layer][1], False))
            buf = caches["cpu"].k if which == 0 else caches["cpu"].v
            buf_card = caches["cuda"].k if which == 0 else caches["cuda"].v
            same_bytes.append(float((buf_card[layer][1].cpu().view(torch.uint8)
                                      == buf[layer][1].view(torch.uint8)).float().mean()))
    parts = []
    for name, mine, ref, fp8 in results:
        finite = bool(torch.isfinite(mine).all())
        diff = (mine - ref).abs()
        # as card_vs_cpu: the sides round at the same points and sum in
        # another order, which can flip a bf16, int8-activation or fp8-KV
        # rounding that two layers carry on
        tol = 5e-2 * float(ref.abs().max())
        if fp8:
            share = float((diff / (torch.maximum(mine.abs(), ref.abs()) / 8 + tol)).max())
            ok = checks.check(f"card vs cpu {name}", share, 1.0)
            what = f"{share:.3f} of its tol (an e4m3 step + {tol:.3e})"
        else:
            ok = checks.check(f"card vs cpu {name}", float(diff.max()), tol)
            what = f"tol {tol:.3e}"
        if not finite:
            checks.failed.append(f"card {name} not finite")
        parts.append(f"{name} {tuple(mine.shape)} max_abs_err {float(diff.max()):.3e} ({what}) "
                     f"{'ok' if ok and finite else 'FAIL'}")
    say(f"[phase 3 card vs cpu, prefill paths: 2 layers at {width} widths, int8 weights, "
        f"packed {list(lens)}, a {chunk_len}-token prompt in chunks of 256] "
        + "; ".join(parts) + f" | fp8 cache bytes equal {min(same_bytes):.4f}-"
        f"{max(same_bytes):.4f} | {time.perf_counter() - t0:.2f}s")
    del sides, caches, card
    torch.cuda.empty_cache()


def paged_card_vs_cpu(torch, checks, base=None, width="8B", seed=SEED + 11, a_len=300,
                      shared=256):
    """The paged path, 2 layers at full 8B widths (or ``base``'s, named
    ``width``), int8 weights, fp8 KV,
    pages of 128: prompt A (``a_len``, 300 tokens) prefilled into slot 0;
    prompt B, sharing A's first ``shared`` (256) tokens (slot 1's table
    starts with A's pages) and 100 of its own, through prefill_suffix_paged
    from there (K8 chunk mode); then
    four decode_step_paged steps (K8 decode mode) in lockstep on the card
    and the CPU, fed the CPU's greedy tokens."""
    import numpy as np

    from flash_attn_tpu_torch.engine.paged import PagedKVPool
    from flash_attn_tpu_torch.models import llama

    t0 = time.perf_counter()
    cfg = dataclasses.replace(base or llama.LLAMA3_8B, num_layers=2)
    card = llama.init_params(cfg, seed=seed, device="cuda", quantize="int8")
    sides = {"cpu": _to(card, "cpu"), "cuda": card}
    rng = np.random.default_rng(seed)
    a = rng.integers(0, cfg.vocab_size, a_len).tolist()
    b = a[:shared] + rng.integers(0, cfg.vocab_size, 100).tolist()
    na, ns = -(-a_len // 128), shared // 128  # A's pages, the shared ones
    nb = -(-len(b) // 128) - ns  # B's own
    mp = max(na, ns + nb)
    pages = (rng.permutation(na + nb) + 1).tolist()  # of a pool of na + nb + 1 (0 null)
    logits = {d: [] for d in sides}
    pools = {}
    for d, params in sides.items():
        pool = PagedKVPool.create(2, na + nb + 1, 128, 2, mp, cfg.num_kv_heads, cfg.head_dim,
                                  mode="fp8", device=d)
        pool.assign_pages(0, pages[:na]).assign_pages(1, pages[:ns] + pages[na:na + nb])
        out, kvs = llama.prefill_with_kv(params, torch.tensor([a], device=d),
                                         torch.arange(len(a), device=d)[None], cfg)
        for layer, (k, v) in enumerate(kvs):
            pool.append_prefill(layer, 0, k[0], v[0], 0)
        logits[d].append(out[0, -1].float().cpu())
        toks = torch.zeros((1, 128), dtype=torch.long, device=d)
        toks[0, :100] = torch.tensor(b[shared:], device=d)
        out, _ = llama.prefill_suffix_paged(params, toks, cfg, pool, 1, shared)
        logits[d].append(out[0, 99].float().cpu())
        pools[d] = pool.set_lengths([len(a), len(b)])
    nxt = torch.stack(logits["cpu"]).argmax(-1)
    for _ in range(4):
        for d, params in sides.items():
            out, _ = llama.decode_step_paged(params, nxt.to(d), cfg, pools[d])
            logits[d].extend(out.float().cpu())
        nxt = torch.stack(logits["cpu"][-2:]).argmax(-1)
    torch.cuda.synchronize()
    ref, got = torch.stack(logits["cpu"]), torch.stack(logits["cuda"])
    finite = bool(torch.isfinite(got).all())
    err = float((got - ref).abs().max())
    # as card_vs_cpu: only summation order differs, which can flip a bf16,
    # int8-activation or fp8-KV rounding that two layers carry on
    tol = 5e-2 * float(ref.abs().max())
    ok = checks.check("paged card vs cpu logits", err, tol) and finite
    if not finite:
        checks.failed.append("paged card logits not finite")
    agree = int((got.argmax(-1) == ref.argmax(-1)).sum())
    say(f"[phase 3 card vs cpu, paged: 2 layers at {width} widths, int8 weights, fp8 KV, "
        f"page 128, suffix prefill from {shared} + 4 decode steps] logits {tuple(got.shape)} "
        f"finite={finite} max_abs_err {err:.3e} (tol {tol:.3e}) {'ok' if ok else 'FAIL'} | "
        f"greedy agreement {agree}/{ref.shape[0]} | {time.perf_counter() - t0:.2f}s")
    del sides, pools, card
    torch.cuda.empty_cache()


def _clone_cache(cache):
    """An independent copy of a KVCache."""
    from flash_attn_tpu_torch.engine.kv_cache import KVCache

    copy = lambda xs: None if xs is None else [x.clone() for x in xs]  # noqa: E731
    return KVCache(copy(cache.k), copy(cache.v), copy(cache.k_scale), copy(cache.v_scale),
                   cache.length.clone(), cache.mode)


def multi_card_vs_cpu(torch, checks, base=None, width="8B", seed=SEED + 18, lens=(100, 37)):
    """The verify step, 2 layers at full 8B widths (or ``base``'s, named
    ``width``), int8 weights, fp8 KV:
    two prompts (``lens``: 100 and 37 tokens), then decode_multi of T=5 tokens per
    sequence (the CPU's greedy first token and four from the seed) on the
    card (K1 in chunk mode) against the CPU (plain versions), and against
    five decode_step calls of the same tokens on the card from a copy of
    the same prefilled cache: the verify step scores what plain decoding
    would."""
    import numpy as np

    from flash_attn_tpu_torch.models import llama

    t0 = time.perf_counter()
    T = 5
    cfg = dataclasses.replace(base or llama.LLAMA3_8B, num_layers=2)
    card = llama.init_params(cfg, seed=seed, device="cuda", quantize="int8")
    sides = {"cpu": _to(card, "cpu"), "cuda": card}
    bucket = 128 * -(-max(lens) // 128)
    caches = {d: llama.make_cache(cfg, 2, 2 * bucket, mode="fp8", device=d) for d in sides}
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]
    first = []
    for slot, prompt in enumerate(prompts):
        toks = torch.zeros((1, bucket), dtype=torch.long)
        toks[0, :len(prompt)] = torch.tensor(prompt)
        for d, params in sides.items():
            out, kvs = llama.prefill_with_kv(params, toks.to(d),
                                             torch.arange(bucket, device=d)[None], cfg)
            for layer, (k, v) in enumerate(kvs):
                caches[d].insert_prompt(layer, slot, k[0], v[0])
            caches[d].set_length(slot, len(prompt))
            if d == "cpu":
                first.append(int(out[0, len(prompt) - 1].argmax()))
    toks = torch.tensor([[f] + rng.integers(0, cfg.vocab_size, T - 1).tolist() for f in first])
    steps_cache = _clone_cache(caches["cuda"])
    multi = {d: llama.decode_multi(params, toks.to(d), cfg, caches[d])[0].float().cpu()
             for d, params in sides.items()}
    steps = []
    for t in range(T):
        out, _ = llama.decode_step(card, toks[:, t].cuda(), cfg, steps_cache)
        steps.append(out.float().cpu())
    torch.cuda.synchronize()
    ref, got, steps = multi["cpu"], multi["cuda"], torch.stack(steps, dim=1)
    finite = bool(torch.isfinite(got).all())
    err, err_steps = float((got - ref).abs().max()), float((got - steps).abs().max())
    # as card_vs_cpu: the sides round at the same points and sum in another
    # order (the decode steps also multiply M=2 rows where the verify step
    # multiplies M=10), which can flip a bf16, int8-activation or fp8-KV
    # rounding that two layers carry on
    tol = 5e-2 * float(ref.abs().max())
    ok = (checks.check("verify step card vs cpu logits", err, tol)
          & checks.check("verify step vs five decode steps on the card", err_steps, tol) and finite)
    lengths_ok = (caches["cuda"].length.tolist() == steps_cache.length.tolist()
                  == [n + T for n in lens])
    if not finite:
        checks.failed.append("verify step logits not finite")
    if not lengths_ok:
        checks.failed.append("verify step lengths differ from five decode steps'")
    agree = int((got.argmax(-1) == ref.argmax(-1)).sum())
    say(f"[phase 3 card vs cpu, verify step: 2 layers at {width} widths, int8 weights, fp8 KV, "
        f"prompts {list(lens)}, decode_multi T={T}] logits {tuple(got.shape)} finite={finite} max_abs_err {err:.3e} vs "
        f"cpu, {err_steps:.3e} vs {T} decode steps (tol {tol:.3e}) "
        f"{'ok' if ok and lengths_ok else 'FAIL'} | greedy agreement {agree}/{2 * T} | "
        f"{time.perf_counter() - t0:.2f}s")
    del sides, caches, steps_cache, card
    torch.cuda.empty_cache()


LORA_RANK = 16         # vLLM's default max_lora_rank
LORA_ALPHA = 32.0
LORA_ADAPTERS = 4
LORA_SHARE = 0.10      # adapters 1-3: the delta's rms over the base projection's at layer 0


def lora_bank(torch, params, seed):
    """LORA_ADAPTERS adapters of rank LORA_RANK (alpha LORA_ALPHA) on all
    seven linear layers of ``params`` (unfused names, as QLoRA adapts
    them), stacked into a bank on the card, fp32 as init_lora makes them
    for a quantized base.  Adapter 0 keeps B = 0; adapters 1-3 draw B from
    the seed, each target's B scaled so that the delta's rms is LORA_SHARE
    of the base projection's output rms at layer 0 on a unit-rms bf16
    input.  Returns (bank, adapter 1's share per target, measured on a
    second such input)."""
    from flash_attn_tpu_torch.models import llama, lora

    gen = torch.Generator(device="cuda").manual_seed(seed)
    adapters = [lora.init_lora(params, LORA_RANK, gen, alpha=LORA_ALPHA)
                for _ in range(LORA_ADAPTERS)]
    blk0 = params["blocks"][0]
    probes = {name: [torch.randn((64, lora.weight_kn(blk0[name])[0]), generator=gen,
                                 device="cuda").to(torch.bfloat16) for _ in range(2)]
              for name in lora.LORA_TARGETS}

    def share(name, ab, x):
        base = llama._proj(x, blk0[name]).float()
        delta = lora.lora_delta(x, ab, None, adapters[0]["scaling"]).float()
        return float(delta.pow(2).mean().sqrt() / base.pow(2).mean().sqrt())

    for a in adapters[1:]:
        for name in lora.LORA_TARGETS:
            for blk in a["blocks"]:
                blk[name][1].normal_(generator=gen)
            f = LORA_SHARE / share(name, a["blocks"][0][name], probes[name][0])
            for blk in a["blocks"]:
                blk[name][1].mul_(f)
    shares = {name: share(name, adapters[1]["blocks"][0][name], probes[name][1])
              for name in lora.LORA_TARGETS}
    return lora.stack_adapters(adapters), shares


def lora_card_vs_cpu(torch, checks, seed=SEED + 31):
    """2 layers at full 8B widths, int8 fused weights, fp8 KV, a bank of
    LORA_ADAPTERS rank-16 adapters (``lora_bank``, adapter 0's B = 0): 8
    prompts of 8-32 tokens prefilled two a call, slots a and a + 4 under
    adapter a (``lora_id`` 0-3), then four decode steps with per-slot ids
    [0, 1, 2, 3, 0, 1, 2, 3], on the card against the CPU, fed the same
    tokens (the CPU's greedy choices).  Both sides hold the fp32 bank and
    cast it to bf16 at each call, as JAX does."""
    import numpy as np

    from flash_attn_tpu_torch.models import llama

    t0 = time.perf_counter()
    cfg = dataclasses.replace(llama.LLAMA3_8B, num_layers=2)
    card = llama.init_params(cfg, seed=seed, device="cuda", quantize="int8")
    bank, _ = lora_bank(torch, card, seed)
    card = llama.fuse_projections(card)
    sides = {"cpu": (_to(card, "cpu"), _to(bank, "cpu")), "cuda": (card, bank)}
    B, S = 2 * LORA_ADAPTERS, 32
    ids = [i % LORA_ADAPTERS for i in range(B)]
    caches = {d: llama.make_cache(cfg, B, 256, mode="fp8", device=d) for d in sides}
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist() for n in rng.integers(8, S + 1, B)]
    first = {d: [None] * B for d in sides}
    for a in range(LORA_ADAPTERS):
        slots = [s for s in range(B) if ids[s] == a]
        toks = torch.zeros((len(slots), S), dtype=torch.long)
        for r, s in enumerate(slots):
            toks[r, :len(prompts[s])] = torch.tensor(prompts[s])
        for d, (params, bk) in sides.items():
            pos = torch.arange(S, device=d)[None].repeat(len(slots), 1)
            out, kvs = llama.prefill_with_kv(params, toks.to(d), pos, cfg, lora=bk, lora_id=a)
            for r, s in enumerate(slots):
                for layer, (k, v) in enumerate(kvs):
                    caches[d].insert_prompt(layer, s, k[r], v[r])
                caches[d].set_length(s, len(prompts[s]))
                first[d][s] = out[r, len(prompts[s]) - 1].float().cpu()
    logits = {d: list(first[d]) for d in sides}
    nxt = torch.stack(first["cpu"]).argmax(-1)
    for _ in range(4):
        for d, (params, bk) in sides.items():
            out, _ = llama.decode_step(params, nxt.to(d), cfg, caches[d], lora=bk,
                                       lora_ids=torch.tensor(ids, device=d))
            logits[d].extend(out.float().cpu())
        nxt = torch.stack(logits["cpu"][-B:]).argmax(-1)
    torch.cuda.synchronize()
    ref, got = torch.stack(logits["cpu"]), torch.stack(logits["cuda"])
    finite = bool(torch.isfinite(got).all())
    err_pre = float((got[:B] - ref[:B]).abs().max())
    err_dec = float((got[B:] - ref[B:]).abs().max())
    # as card_vs_cpu: the sides round at the same points (the deltas' rank-16
    # products in bf16 on both) and sum in another order
    tol = 5e-2 * float(ref.abs().max())
    ok = (checks.check("LoRA card vs cpu prefill logits", err_pre, tol)
          & checks.check("LoRA card vs cpu decode logits", err_dec, tol) and finite)
    if not finite:
        checks.failed.append("LoRA card logits not finite")
    agree = int((got.argmax(-1) == ref.argmax(-1)).sum())
    say(f"[phase 3 card vs cpu, LoRA: 2 layers at 8B widths, int8 fused, fp8 KV, a bank of "
        f"{LORA_ADAPTERS} rank-{LORA_RANK} adapters, fp32] prefill lora_id 0-3 (slots a, a + 4) "
        f"logits ({B}, {cfg.vocab_size}) max_abs_err {err_pre:.3e}; 4 decode steps, lora_ids "
        f"{ids}, logits ({4 * B}, {cfg.vocab_size}) max_abs_err {err_dec:.3e} (tol {tol:.3e}, "
        f"max |logit| {float(ref.abs().max()):.3f}) finite={finite} {'ok' if ok else 'FAIL'} | "
        f"greedy agreement {agree}/{ref.shape[0]} | {time.perf_counter() - t0:.2f}s")
    del sides, caches, card, bank
    torch.cuda.empty_cache()


def qwen_card_vs_cpu(torch, checks):
    """Phase 3's Llama runs at 2 layers of Qwen-2-7B's widths (28 query
    heads over 4 KV heads, the qkv bias; int8 weights, the bias bf16), held
    as the Llama rows are: prompts and decode steps, the prefill paths, the
    paged path and the verify step."""
    from flash_attn_tpu_torch.models import llama

    qwen = dict(base=llama.QWEN2_7B, width="Qwen-2-7B")
    card_vs_cpu(torch, checks, "int8 weights, qkv bias", "int8", None, False, seed=SEED + 62,
                **qwen)
    prefill_card_vs_cpu(torch, checks, seed=SEED + 63, **qwen)
    paged_card_vs_cpu(torch, checks, seed=SEED + 64, **qwen)
    multi_card_vs_cpu(torch, checks, seed=SEED + 65, **qwen)


def mistral_card_vs_cpu(torch, checks):
    """Phase 3's prefill, paged and verify rows at 2 layers of Mistral-7B's
    widths (``mistral_7b``: 32 query heads over 8 KV heads; int8 weights)
    with the window cut to 512, so that prompts of about 1000 tokens run
    past it: packed prompts of 700, 250 and 50 and a 1000-token prompt in
    chunks of 256 (K4's masked kLocal instance), a 768-token prompt and a
    suffix prefill from 640 (K8c) with four paged decode steps (K8), and a
    verify step after prompts of 800 and 600 (K1c), each held as the Llama
    rows are: logits within 5 % of the CPU's max logit."""
    mistral = dict(base=dataclasses.replace(mistral_7b(), sliding_window=512),
                   width="Mistral-7B, window 512")
    prefill_card_vs_cpu(torch, checks, seed=SEED + 91, lens=(700, 250, 50), chunk_len=1000,
                        **mistral)
    paged_card_vs_cpu(torch, checks, seed=SEED + 92, a_len=768, shared=640, **mistral)
    multi_card_vs_cpu(torch, checks, seed=SEED + 93, lens=(800, 600), **mistral)


# phase 3's Mistral training check: its widths at 2 layers, the window cut
# to 256 and three documents packed in 1024 tokens, the first past it
MISTRAL_TRAIN_CVC_DOCS = (600, 250, 174)
MISTRAL_TRAIN_CVC_WINDOW = 256


def mistral_train_card_vs_cpu(torch, checks, seed=SEED + 96):
    """The training check for a windowed Llama on packed documents: 2
    layers at Mistral-7B's widths, the window cut to MISTRAL_TRAIN_CVC_WINDOW,
    B=1, S=1024 holding MISTRAL_TRAIN_CVC_DOCS (segment ids 1-3, positions
    restarting a document; the window on the indices): K4's masked kLocal
    instance's twin forward, K9's and K10's kLocal and kOpt twin
    backward."""
    from flash_attn_tpu_torch.models import llama

    t0 = time.perf_counter()
    cfg = dataclasses.replace(mistral_7b(), num_layers=2,
                              sliding_window=MISTRAL_TRAIN_CVC_WINDOW)
    card = llama.init_params(cfg, seed=seed, device="cuda")
    _train_card_vs_cpu(torch, checks, f"Mistral-7B training: 2 layers at its widths, the window "
                       f"cut to {MISTRAL_TRAIN_CVC_WINDOW}, documents {MISTRAL_TRAIN_CVC_DOCS}",
                       "Mistral ", card, _packed_train_fwd(torch, cfg, MISTRAL_TRAIN_CVC_DOCS),
                       cfg.vocab_size, sum(MISTRAL_TRAIN_CVC_DOCS), seed, t0)


# the share of tokens whose top-2 expert set may differ between the card and
# the CPU in any one layer of phase 3's Mixtral runs, both routing the same
# input (see there)
MOE_FLIP_SHARE = 0.01


def mixtral_card_vs_cpu(torch, checks, quantize, seed):
    """2 layers at Mixtral-8x7B's widths (8 experts of 4096 x 14336, top 2;
    ``quantize``: int8, or int4 at g=128) with fp8 KV: two 256-token
    prompts in one prefill_with_kv call (B=2), then three decode steps fed
    the CPU's greedy tokens, on the card and on the CPU.

    MoE routing is discontinuous: a near tie between a token's 2nd and 3rd
    router logits can flip its top-2 set between the two sides, and that
    token's output with it, however small the rounding that caused it.  A
    flipped token's K/V then differ in the layers above, so every later row
    of its sequence sees another context, and the next layer's routers see
    inputs that differ by more than rounding: flips cascade, and the router
    (logits of std ~6 on a unit input) amplifies the rounding of the layers
    below it.  End to end, the logits of tokens that agree everywhere come
    within the order of the 5 % tolerance.  So each layer is held on the
    same input: the card runs each layer alone, fed the CPU's hidden state
    entering it (the prompts' 512 tokens, passed as the embedding table,
    one row a token), and
    - the share of tokens whose top-2 set (the nonzeros of router_topk,
      wrapped for the phase) differs from the CPU's must be at most
      MOE_FLIP_SHARE (1 %) in every layer;
    - on the tokens whose sets agree at that layer, the layer's output
      (its hidden state; for the last layer, the logits) must be within
      card_vs_cpu's 5 % of the CPU's largest value.
    The end-to-end run's flips and logit errors (the rows that agree and
    that no lower layer's flip reaches; the rows after such a flip) are
    printed beside them."""
    import numpy as np

    from flash_attn_tpu_torch.models import mixtral as mx
    from flash_attn_tpu_torch.parallel.moe import router_topk

    t0 = time.perf_counter()
    cfg = dataclasses.replace(mx.MIXTRAL_8X7B, num_layers=2)
    L, H, S = cfg.num_layers, cfg.hidden, 256
    card = mx.init_params(cfg, seed=seed, device="cuda", quantize=quantize)
    sides = {"cpu": _to(card, "cpu"), "cuda": card}
    caches = {d: mx.make_cache(cfg, 2, 512, mode="fp8", device=d) for d in sides}
    toks = torch.from_numpy(np.random.default_rng(seed).integers(0, cfg.vocab_size, (2, S)))
    sets = {d: [] for d in (*sides, "forced")}
    logits = {d: [] for d in sides}
    hidden = {"cpu": [], "forced": []}  # prefill hidden states after each layer
    moe_mlp = mx._moe_mlp

    def recording(side):
        def route(x, k):
            w = router_topk(x, k)
            sets[side].append((w > 0).cpu())
            return w
        return route

    def keeping(side):
        def mlp(x, blk, c):
            out = moe_mlp(x, blk, c)
            hidden[side].append(out.float().cpu())
            return out
        return mlp

    try:
        for d, params in sides.items():
            mx.router_topk = recording(d)
            mx._moe_mlp = keeping("cpu") if d == "cpu" else moe_mlp
            out, kvs = mx.prefill_with_kv(params, toks.to(d),
                                          torch.arange(S, device=d)[None].expand(2, S), cfg)
            mx._moe_mlp = moe_mlp
            for layer, (k, v) in enumerate(kvs):
                caches[d].append(layer, k, v)
            caches[d].advance(S)
            logits[d].append(out.reshape(-1, cfg.vocab_size).float().cpu())
            del out, kvs
        nxt = logits["cpu"][0].reshape(2, S, -1)[:, -1].argmax(-1)
        for _ in range(3):
            for d, params in sides.items():
                mx.router_topk = recording(d)
                out, _ = mx.decode_step(params, nxt.to(d), cfg, caches[d])
                logits[d].append(out.float().cpu())
            nxt = logits["cpu"][-1].argmax(-1)
        # each layer alone on the card, fed the CPU's hidden state entering it
        mx.router_topk, mx._moe_mlp = recording("forced"), keeping("forced")
        one = dataclasses.replace(cfg, num_layers=1)
        for layer in range(L):
            x = (card["tok_emb"][toks.cuda()] if layer == 0
                 else hidden["cpu"][layer - 1].cuda().to(card["tok_emb"].dtype))
            alone = dict(card, tok_emb=x.reshape(-1, H), blocks=[card["blocks"][layer]])
            alone.pop("_lm_head_f32", None)
            out, _ = mx.prefill_with_kv(alone, torch.arange(2 * S, device="cuda").reshape(2, S),
                                        torch.arange(S, device="cuda")[None].expand(2, S), one)
            del alone, x
        forced_logits = out.reshape(-1, cfg.vocab_size).float().cpu()
        del out
    finally:
        mx.router_topk, mx._moe_mlp = router_topk, moe_mlp
    torch.cuda.synchronize()
    # per layer, on the same input: the sets and the layer's output
    ok, parts = True, []
    for layer in range(L):
        cpu_sets = torch.cat(sets["cpu"][layer::L])[:2 * S]
        agree = ~(sets["forced"][layer] != cpu_sets).any(-1)
        share = 1 - float(agree.float().mean())
        if layer == L - 1:
            ref, got, what = logits["cpu"][0], forced_logits, "logits"
        else:
            ref = hidden["cpu"][layer].reshape(2 * S, H)
            got, what = hidden["forced"][layer].reshape(2 * S, H), "hidden state"
        err = float((got[agree] - ref[agree]).abs().max())
        # as card_vs_cpu: the sides round at the same points and sum in
        # another order, which can flip a bf16, int8-activation or fp8-KV
        # rounding
        tol = 5e-2 * float(ref.abs().max())
        ok &= checks.check(f"Mixtral {quantize} layer {layer} top-2 sets differing on the same "
                           "input", share, MOE_FLIP_SHARE)
        ok &= checks.check(f"Mixtral {quantize} layer {layer} {what} on the same input", err, tol)
        if not bool(torch.isfinite(got).all()):
            checks.failed.append(f"Mixtral {quantize} layer {layer} {what} not finite")
            ok = False
        parts.append(f"layer {layer}: sets differing {share:.5f} of {2 * S} tokens (limit "
                     f"{MOE_FLIP_SHARE}), {what} max_abs_err {err:.3e} (tol {tol:.3e})")
    # end to end (printed): a flip below the last layer changes the token's
    # K/V in the layers above it, which every later row of its sequence
    # attends to
    differ = torch.stack([
        (torch.cat(sets["cuda"][layer::L]) != torch.cat(sets["cpu"][layer::L])).any(-1)
        for layer in range(L)])  # [L, tokens]
    ref, got = torch.cat(logits["cpu"]), torch.cat(logits["cuda"])
    rowerr = (got - ref).abs().amax(-1)
    agree = ~differ.any(0)
    seq = torch.cat([torch.zeros(S), torch.ones(S), torch.tensor([0.0, 1.0] * 3)]).long()
    reach = differ[:L - 1].any(0)
    clean = agree.clone()
    for b in (0, 1):
        idx = (seq == b).nonzero()[:, 0]
        clean[idx] &= ~torch.cummax(reach[idx].int(), 0).values.bool()
    after = agree & ~clean
    e2e = (f"end to end: sets differing {[round(x, 5) for x in differ.float().mean(-1).tolist()]}"
           f" of {differ.shape[1]} tokens, flipped "
           f"{[differ[i].nonzero()[:, 0].tolist() for i in range(L)]}; logits max_abs_err "
           f"{float(rowerr[clean].max()):.3e} on the {int(clean.sum())} rows that agree and "
           f"that no lower layer's flip reaches, "
           f"{float(rowerr[after].max()) if bool(after.any()) else 0.0:.3e} on the "
           f"{int(after.sum())} after such a flip (5 % of the max logit: "
           f"{5e-2 * float(ref.abs().max()):.3e}); greedy agreement "
           f"{int((got.argmax(-1) == ref.argmax(-1)).sum())}/{ref.shape[0]}")
    if not bool(torch.isfinite(got).all()):
        checks.failed.append(f"Mixtral {quantize} card logits not finite")
        ok = False
    say(f"[phase 3 card vs cpu, Mixtral: 2 layers at 8x7B widths, {quantize} experts and "
        f"attention, fp8 KV, 2 x {S} prompt tokens + 3 decode steps] each layer on the card fed "
        f"the CPU's input: " + "; ".join(parts) + f" {'ok' if ok else 'FAIL'} | (not held) "
        f"{e2e} | {time.perf_counter() - t0:.2f}s")
    del sides, caches, card, hidden
    torch.cuda.empty_cache()


def _train_fwd(cfg):
    from flash_attn_tpu_torch.models import llama

    return lambda p, tokens, remat: llama.forward(p, tokens, cfg, remat=remat)


def _packed_train_fwd(torch, cfg, docs, forward=None):
    """The training forward (``forward``, default ``llama.forward``) of
    documents ``docs`` packed in each row: segment ids 1, 2, ... a document
    and RoPE positions restarting at 0 a document, on the tokens' device."""
    from flash_attn_tpu_torch.models import llama

    forward = forward or llama.forward
    seg, pos = _packed_docs(torch, docs, device="cpu")

    def fwd(p, tokens, remat):
        b, dev = tokens.shape[0], tokens.device
        return forward(p, tokens, cfg, positions=pos.expand(b, -1).to(dev),
                       segment_ids=seg.expand(b, -1).to(dev), remat=remat)
    return fwd


def _train_card_vs_cpu(torch, checks, label, tag, card, fwd, vocab, seq, seed, t0):
    """One training loss and every parameter's gradient (the train step's
    forward and backward, remat on) of ``card`` (bf16 params on the card,
    copied to the CPU), B=1, S=``seq`` from ``seed``: on the card (K4, K9,
    K10) against the CPU (plain versions; the CPU's bf16 GEMMs as fp32
    matmuls rounded once, ``_cpu_bf16_gemm``)."""
    import numpy as np

    from flash_attn_tpu_torch.models import llama
    from flash_attn_tpu_torch.utils import train

    sides = {"cpu": _to(card, "cpu"), "cuda": card}
    batch = np.random.default_rng(seed).integers(0, vocab, (1, seq + 1))
    res = {}
    matmul = llama.quantized_matmul
    try:
        llama.quantized_matmul = _cpu_bf16_gemm(torch, matmul)
        for d, params in sides.items():
            for p in train.param_leaves(params):
                p.requires_grad_(True)
            toks = torch.from_numpy(batch).to(d)
            loss, grads = train.loss_and_grads(fwd, params, toks[:, :-1], toks[:, 1:])
            res[d] = (float(loss), [gr.float().cpu() for gr in grads])
    finally:
        llama.quantized_matmul = matmul
    torch.cuda.synchronize()
    names = [name for name, _ in train.named_leaves(card)]
    (lc, g_cpu), (lg, gg) = res["cpu"], res["cuda"]
    finite = all(bool(torch.isfinite(x).all()) for x in gg) and np.isfinite(lg)
    # bf16 activations and gradients: the card (cuBLAS, K4/K9/K10) and the
    # CPU (the plain versions) round at the same points and sum in another
    # order, which can flip a bf16 rounding (2^-8) that two layers and the
    # backward carry on; measured on an NVIDIA H100 80GB HBM3 at 700 W
    # (Llama, S=128): loss 9.3e-05, worst gradient 1.8e-02 of its norm (wk,
    # through the softmax)
    lerr = abs(lg - lc) / abs(lc)
    ok = checks.check(f"{tag}train card vs cpu loss (relative)", lerr, TRAIN_LOSS_TOL) and finite
    worst, worst_name = 0.0, ""
    for name, a, b in zip(names, gg, g_cpu):
        e = float((a - b).norm() / b.norm().clamp(min=1e-30))
        ok = checks.check(f"{tag}train card vs cpu grad {name} (relative norm)", e,
                          TRAIN_GRAD_TOL) and ok
        if e > worst:
            worst, worst_name = e, name
    if not finite:
        checks.failed.append(f"{tag}train card loss or gradients not finite")
    say(f"[phase 3 card vs cpu, {label}, bf16, B=1 S={seq}, remat] "
        f"loss {lg:.6f} (cpu {lc:.6f}, relative err {lerr:.3e}, tol {TRAIN_LOSS_TOL:g}) | "
        f"{len(gg)} gradients finite={finite}, worst relative norm err {worst:.3e} "
        f"({worst_name}; tol {TRAIN_GRAD_TOL:g}) {'ok' if ok else 'FAIL'} | "
        f"{time.perf_counter() - t0:.2f}s")
    del sides, res
    gc.collect()
    torch.cuda.empty_cache()


def train_card_vs_cpu(torch, checks):
    """The training check at 2 layers of full 8B widths, S=128; then the
    same with packed documents (phase 19's proportions in 128 tokens:
    64, 32, 20 and 12, segment ids 1-4, positions restarting a document):
    K4's masked instance forward, K9's and K10's kOpt instances backward."""
    from flash_attn_tpu_torch.models import llama

    t0 = time.perf_counter()
    cfg = dataclasses.replace(llama.LLAMA3_8B, num_layers=2)
    card = llama.init_params(cfg, seed=SEED + 13, device="cuda")
    _train_card_vs_cpu(torch, checks, "training: 2 layers at 8B widths", "", card,
                       _train_fwd(cfg), cfg.vocab_size, 128, SEED + 13, t0)
    t0 = time.perf_counter()
    card = llama.init_params(cfg, seed=SEED + 72, device="cuda")
    _train_card_vs_cpu(torch, checks, "packed training: 2 layers at 8B widths, documents "
                       "(64, 32, 20, 12)", "packed ", card,
                       _packed_train_fwd(torch, cfg, (64, 32, 20, 12)), cfg.vocab_size, 128,
                       SEED + 72, t0)


MIXTRAL_TRAIN_CVC_SEQ = 128  # phase 3's Mixtral training check: B=1 tokens


def _cpu_bf16_gemm(torch, matmul):
    """``matmul`` (the models' quantized_matmul) with each bf16 x bf16
    product on the CPU taken as an fp32 matmul of the same bf16 values,
    rounded to bf16 once: the products, the fp32 sums and the rounding
    points of a bf16 GEMM (and, through autograd, of its backward), about
    5x faster than the host's bf16 GEMM.  Every other call is
    ``matmul``'s."""
    def gemm(x, w, **kw):
        if (x.device.type == "cpu" and isinstance(w, torch.Tensor) and not kw
                and x.dtype == w.dtype == torch.bfloat16):
            return (x.float() @ w.float()).to(torch.bfloat16)
        return matmul(x, w, **kw)
    return gemm


def mixtral_train_card_vs_cpu(torch, checks, seed=SEED + 81):
    """One training loss and every parameter's gradient of Mixtral at 2
    layers of 8x7B's widths (bf16, B=1, S=MIXTRAL_TRAIN_CVC_SEQ), on the
    card (K4, K9, K10, remat on) against the CPU (plain versions).

    The loss of the whole forward is held to TRAIN_LOSS_TOL.  The router
    amplifies rounding and a near tie can flip a token's top-2 set (see
    mixtral_card_vs_cpu), so the gradients are held piece by piece, each
    piece on the card fed the CPU's input and the CPU's gradient of the
    loss at its output: the head (final norm, lm_head and the loss) on the
    CPU's last hidden state; each layer alone (checkpointed, as remat runs
    it) on the CPU's hidden state entering it; the embedding on the
    gradient that layer 0 gives its input on each side.  A token whose
    top-2 set differs between the card and the CPU at a layer gets zero
    upstream gradient in that layer on both sides; at most MOE_FLIP_SHARE
    of a layer's tokens may differ.  Each parameter's gradient is then
    held to TRAIN_GRAD_TOL of its norm.  The CPU's bf16 GEMMs run as
    ``_cpu_bf16_gemm``."""
    import numpy as np
    from torch.utils.checkpoint import checkpoint

    from flash_attn_tpu_torch.models import llama
    from flash_attn_tpu_torch.models import mixtral as mx
    from flash_attn_tpu_torch.ops.rope import rope_cos_sin
    from flash_attn_tpu_torch.parallel.moe import router_topk
    from flash_attn_tpu_torch.utils import train

    t0 = time.perf_counter()
    cfg = dataclasses.replace(mx.MIXTRAL_8X7B, num_layers=2)
    S, L = MIXTRAL_TRAIN_CVC_SEQ, cfg.num_layers
    card = mx.init_params(cfg, seed=seed, device="cuda")
    sides = {"cpu": _to(card, "cpu"), "cuda": card}
    batch = torch.from_numpy(np.random.default_rng(seed).integers(0, cfg.vocab_size, (1, S + 1)))
    tok, tgt = batch[:, :-1], batch[:, 1:]
    pos = torch.arange(S)[None]
    rope = {d: rope_cos_sin(pos.to(d), cfg.head_dim, cfg.rope_theta) for d in sides}
    for params in sides.values():
        for p in train.param_leaves(params):
            p.requires_grad_(True)
    with torch.no_grad():  # the card's loss through the whole forward
        loss = {"cuda": float(train.cross_entropy(mx.forward(card, tok.cuda(), cfg),
                                                  tgt.cuda()))}
    routed = []

    def recording(x, k):
        w = router_topk(x, k)
        routed.append((w > 0).cpu())
        return w

    def block(d, blk, x):
        return llama._block_train(x, blk, cfg, *rope[d], mx._moe_mlp)

    def top(params, x):
        h = llama._rms_norm(x, params["final_norm"], cfg.rms_eps)
        return train.cross_entropy(llama._proj(h.float(), params["lm_head"]), tgt.to(x.device))

    errs, lines, finite = {}, [], True
    matmul = llama.quantized_matmul
    try:
        mx.router_topk, llama.quantized_matmul = recording, _cpu_bf16_gemm(torch, matmul)
        cpu = sides["cpu"]
        # the CPU's input to each layer (then the head's), and each layer's
        # output with its graph
        t1 = time.perf_counter()
        xs, ys = [cpu["tok_emb"][tok].detach().requires_grad_(True)], []
        for blk in cpu["blocks"]:
            ys.append(block("cpu", blk, xs[-1]))
            xs.append(ys[-1].detach().requires_grad_(True))
        cpu_sets = routed[:]
        t_cpu = time.perf_counter() - t1
        # the head; the CPU's loss is that of its whole forward
        grads = {}
        for d, params in sides.items():
            x = xs[L].to(d).requires_grad_(True)
            leaves = [params["final_norm"], params["lm_head"], x]
            head_loss = top(params, x)
            grads[d] = torch.autograd.grad(head_loss, leaves)
            if d == "cpu":
                loss["cpu"] = float(head_loss.detach())
        for name, i in (("final_norm", 0), ("lm_head", 1)):
            errs[name] = _rel_norm(grads["cuda"][i], grads["cpu"][i].cuda())
        upstream = grads["cpu"][2]  # the CPU's gradient at the last layer's output
        # each layer alone, from the top down
        for layer in reversed(range(L)):
            names = [f"blocks.{layer}.{n}" for n, _ in train.named_leaves(cpu["blocks"][layer])]
            x = xs[layer].detach().cuda().requires_grad_(True)
            routed.clear()
            y = checkpoint(block, "cuda", card["blocks"][layer], x, use_reentrant=False)
            out = {"cpu": (xs[layer], ys[layer], train.param_leaves(cpu["blocks"][layer])),
                   "cuda": (x, y, train.param_leaves(card["blocks"][layer]))}
            differ = (routed[0] != cpu_sets[layer]).any(-1)  # [S]
            masked = upstream.clone()
            masked[0, differ] = 0
            got = {}
            for d, (x, y, leaves) in out.items():
                t1 = time.perf_counter()
                got[d] = torch.autograd.grad(y, leaves + [x], masked.to(d),
                                             retain_graph=d == "cpu" and bool(differ.any()))
                if d == "cpu":
                    t_cpu += time.perf_counter() - t1
            finite &= all(bool(torch.isfinite(g).all()) for g in got["cuda"])
            for name, a, b in zip(names, got["cuda"][:-1], got["cpu"][:-1]):
                errs[name] = _rel_norm(a, b.cuda())
            x, y, _ = out["cpu"]
            # the CPU's whole gradient at this layer's input, for the layer below
            t1 = time.perf_counter()
            nxt = (torch.autograd.grad(y, [x], upstream)[0] if bool(differ.any())
                   else got["cpu"][-1])
            t_cpu += time.perf_counter() - t1
            share = float(differ.float().mean())
            checks.check(f"Mixtral training layer {layer} top-2 sets differing on the same "
                         "input", share, MOE_FLIP_SHARE)
            lines.append(f"layer {layer}: {int(differ.sum())} of {S} tokens' sets differ "
                         f"({share:.5f}, limit {MOE_FLIP_SHARE})")
            dx = {d: got[d][-1] for d in got}
            upstream = nxt
            del out, got
        # the embedding, on each side's gradient at layer 0's input
        emb = {}
        for d, params in sides.items():
            emb[d] = torch.autograd.grad(params["tok_emb"][tok.to(d)], [params["tok_emb"]],
                                         dx[d].to(params["tok_emb"].dtype))[0]
        errs["tok_emb"] = _rel_norm(emb["cuda"], emb["cpu"].cuda())
        finite &= bool(torch.isfinite(emb["cuda"]).all())
    finally:
        mx.router_topk, llama.quantized_matmul = router_topk, matmul
    torch.cuda.synchronize()
    lerr = abs(loss["cuda"] - loss["cpu"]) / abs(loss["cpu"])
    ok = checks.check("Mixtral train card vs cpu loss (relative)", lerr, TRAIN_LOSS_TOL)
    for name, e in errs.items():
        ok = checks.check(f"Mixtral train card vs cpu grad {name} (relative norm)", e,
                          TRAIN_GRAD_TOL) and ok
    if not (finite and np.isfinite(loss["cuda"])):
        checks.failed.append("Mixtral train card loss or gradients not finite")
        ok = False
    worst = max(errs, key=errs.get)
    say(f"[phase 3 card vs cpu, Mixtral training: 2 layers at 8x7B widths, bf16, B=1 S={S}, "
        f"remat] loss {loss['cuda']:.6f} (cpu {loss['cpu']:.6f}, relative err {lerr:.3e}, tol "
        f"{TRAIN_LOSS_TOL:g}) | each piece on the card fed the CPU's input and output gradient: "
        + "; ".join(reversed(lines)) + f" | {len(errs)} gradients finite={finite}, worst "
        f"relative norm err {errs[worst]:.3e} ({worst}; tol {TRAIN_GRAD_TOL:g}), router "
        + ", ".join(f"{errs[f'blocks.{i}.router']:.3e}" for i in range(L))
        + f" {'ok' if ok else 'FAIL'} | {time.perf_counter() - t0:.2f}s (the CPU's forward "
        f"and layers' backward {t_cpu:.2f}s)")
    del sides, card, xs, ys, grads, emb
    gc.collect()
    torch.cuda.empty_cache()


# Gemma-2 at 2 layers on the card against the CPU: the window is cut to 512
# so that a 1000-token prompt crosses it (on the CPU too)
GEMMA_CVC_WINDOW, GEMMA_CVC_PROMPT = 512, 1000


def gemma_card_vs_cpu(torch, checks, size="9B", seed=SEED + 5):
    """2 layers of Gemma-2 at full 9B (or ``size`` "27B") widths (layer 0
    slides, layer 1 is global), int8 weights, fp8 KV, the window cut to
    GEMMA_CVC_WINDOW: a 1000-token prompt (the 1024 bucket) and four decode
    steps in lockstep on the card (K4 and K1 with window and softcap, at
    head_dim 256; at 27B's 128 K4's kLocal instance beside Llama's) and on
    the CPU (their plain versions), fed the CPU's greedy tokens; logits
    within 5 % of the largest, as card_vs_cpu holds them."""
    import numpy as np

    from flash_attn_tpu_torch.models import gemma2

    t0 = time.perf_counter()
    base = gemma2.GEMMA2_27B if size == "27B" else gemma2.GEMMA2_9B
    cfg = dataclasses.replace(base, num_layers=2, sliding_window=GEMMA_CVC_WINDOW)
    card = gemma2.init_params(cfg, seed=seed, device="cuda", quantize="int8")
    sides = {"cpu": _to(card, "cpu"), "cuda": card}
    caches = {d: gemma2.make_cache(cfg, 1, 1280, mode="fp8", device=d) for d in sides}
    prompt = np.random.default_rng(seed).integers(0, cfg.vocab_size, GEMMA_CVC_PROMPT)
    toks = torch.zeros((1, 1024), dtype=torch.long)
    toks[0, :len(prompt)] = torch.from_numpy(prompt)
    logits = {d: [] for d in sides}
    for d, params in sides.items():
        out, kvs = gemma2.prefill_with_kv(params, toks.to(d), torch.arange(1024, device=d)[None],
                                          cfg)
        for layer, (k, v) in enumerate(kvs):
            caches[d].insert_prompt(layer, 0, k[0], v[0])
        caches[d].set_length(0, len(prompt))
        logits[d].append(out[0, len(prompt) - 1].float().cpu())
        del out, kvs
    nxt = logits["cpu"][0].argmax()[None]
    for _ in range(4):
        for d, params in sides.items():
            out, _ = gemma2.decode_step(params, nxt.to(d), cfg, caches[d])
            logits[d].append(out[0].float().cpu())
        nxt = logits["cpu"][-1].argmax()[None]
    torch.cuda.synchronize()
    ref = torch.stack(logits["cpu"])
    got = torch.stack(logits["cuda"])
    finite = bool(torch.isfinite(got).all())
    err = float((got - ref).abs().max())
    # as card_vs_cpu: the sides round at the same points and sum in another
    # order, which can flip a bf16, int8-activation or fp8-KV rounding that
    # two layers carry into the (capped) logits
    tol = 5e-2 * float(ref.abs().max())
    ok = checks.check(f"card vs cpu logits, Gemma-2 {size}", err, tol) and finite
    if not finite:
        checks.failed.append(f"card logits not finite, Gemma-2 {size}")
    agree = int((got.argmax(-1) == ref.argmax(-1)).sum())
    say(f"[phase 3 card vs cpu, Gemma-2: 2 layers at {size} widths (layer 0 slides, layer 1 "
        f"global), int8 weights, fp8 KV, the window cut to {GEMMA_CVC_WINDOW} so the "
        f"{GEMMA_CVC_PROMPT}-token prompt crosses it] logits {tuple(got.shape)} finite={finite} "
        f"max_abs_err {err:.3e} (tol {tol:.3e}, max |logit| {float(ref.abs().max()):.3f}) "
        f"{'ok' if ok else 'FAIL'} | greedy agreement {agree}/{ref.shape[0]} | "
        f"{time.perf_counter() - t0:.2f}s")
    del sides, caches, card
    gc.collect()
    torch.cuda.empty_cache()


def gemma_train_card_vs_cpu(torch, checks, size="9B", seed=SEED + 15):
    """The training check for Gemma-2: 2 layers at full 9B (or ``size``
    "27B") widths (layer 0 slides, layer 1 is global), the window cut to
    GEMMA_CVC_WINDOW, S=1024 (K4, K9, K10 with window and softcap: at
    head_dim 256, or at 27B's 128 their kLocal instances beside Llama's)."""
    from flash_attn_tpu_torch.models import gemma2

    t0 = time.perf_counter()
    base = gemma2.GEMMA2_27B if size == "27B" else gemma2.GEMMA2_9B
    cfg = dataclasses.replace(base, num_layers=2, sliding_window=GEMMA_CVC_WINDOW)
    card = gemma2.init_params(cfg, seed=seed, device="cuda")
    fwd = lambda p, tokens, remat: gemma2.forward(p, tokens, cfg, remat=remat)  # noqa: E731
    _train_card_vs_cpu(torch, checks, f"Gemma-2 training: 2 layers at {size} widths (layer 0 "
                       f"slides, layer 1 global), the window cut to {GEMMA_CVC_WINDOW}",
                       f"Gemma-2 {size} ", card, fwd, cfg.vocab_size, 1024, seed, t0)


def _gpt2_cfg(**kw):
    """GPT-2 124M's config in bf16 (BASELINE config 0's "BF16 weights"),
    with ``kw`` replaced."""
    from flash_attn_tpu_torch.models import gpt2

    return dataclasses.replace(gpt2.GPT2_124M, dtype="bfloat16", **kw)


def gpt2_train_card_vs_cpu(torch, checks):
    """The training check for GPT-2: 2 layers at 124M widths, bf16, B=1,
    S=1024 (K4, K9 and K10 at head_dim 64; the tied wte through the
    gather and the head)."""
    from flash_attn_tpu_torch.models import gpt2

    t0 = time.perf_counter()
    cfg = _gpt2_cfg(num_layers=2)
    card = gpt2.init_params(cfg, seed=SEED + 17, device="cuda")
    fwd = lambda p, tokens, remat: gpt2.forward(p, tokens, cfg, remat=remat)  # noqa: E731
    _train_card_vs_cpu(torch, checks, "GPT-2 training: 2 layers at 124M widths", "GPT-2 ", card,
                       fwd, cfg.vocab_size, 1024, SEED + 17, t0)


def gpt2_card_vs_cpu(torch, checks):
    """2 layers of GPT-2 at 124M widths, bf16, int8 KV, on the card (K4,
    K1, K2, K1m, K1c and K8 at head_dim 64) and on the CPU (their plain
    versions), fed the CPU's greedy tokens, the logits compared within 5 %
    of the largest, as card_vs_cpu holds them: a 300- and a 37-token
    prompt (prefill_with_kv, the 512 and 64 buckets) into slots 0 and 1 of
    a cache of 1024 positions whose slot 2 is idle at 1030, past
    max_position (its position index is clamped; both sides skip its
    appends), then four decode steps, then decode_multi of 5 tokens; the
    same two prompts packed (prefill_packed, 337 tokens in the 512 bucket)
    beside a third of 57 (394 in 512); a 700-token prompt through
    prefill_chunk in chunks of 256; the two prompts into a paged pool of
    pages of 128 and four decode_step_paged steps.  An fp32 model on the
    card must raise from the kernels' dtype checks, not be cast quietly."""
    import numpy as np

    from flash_attn_tpu_torch.engine.paged import PagedKVPool
    from flash_attn_tpu_torch.models import gpt2

    t0 = time.perf_counter()
    cfg = _gpt2_cfg(num_layers=2)
    card = gpt2.init_params(cfg, seed=SEED + 54, device="cuda")
    sides = {"cpu": _to(card, "cpu"), "cuda": card}
    rng = np.random.default_rng(SEED + 54)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (300, 37, 57)]
    results = []

    def compare(name, logits):
        results.append((name, torch.stack(logits["cuda"]), torch.stack(logits["cpu"])))

    # a prompt a call into a contiguous cache, an idle slot past max_position
    caches = {d: gpt2.make_cache(cfg, 3, 1024, mode="int8", device=d) for d in sides}
    logits = {d: [] for d in sides}
    for slot, prompt in enumerate(prompts[:2]):
        n = len(prompt)
        bucket = 512 if n > 64 else 64
        toks = torch.zeros((1, bucket), dtype=torch.long)
        toks[0, :n] = torch.tensor(prompt)
        for d, params in sides.items():
            out, kvs = gpt2.prefill_with_kv(params, toks.to(d),
                                            torch.arange(bucket, device=d)[None], cfg)
            for layer, (k, v) in enumerate(kvs):
                caches[d].insert_at(layer, slot, k[0, :n], v[0, :n], 0)
            caches[d].set_length(slot, n)
            logits[d].append(out[0, n - 1].float().cpu())
    for d in sides:
        caches[d].set_length(2, 1030)
    compare("prefill_with_kv", logits)
    nxt = torch.stack(logits["cpu"]).argmax(-1).tolist() + [0]
    logits = {d: [] for d in sides}
    for _ in range(4):
        for d, params in sides.items():
            out, _ = gpt2.decode_step(params, torch.tensor(nxt, device=d), cfg, caches[d])
            logits[d].extend(out.float().cpu())
        nxt = torch.stack(logits["cpu"][-3:]).argmax(-1).tolist()
    compare("decode_step x4 (slot 2 idle past max_position)", logits)
    lengths_ok = [int(x) for x in caches["cuda"].length] == [304, 41, 1034]
    multi = torch.tensor([nxt[:1] + rng.integers(0, cfg.vocab_size, 4).tolist()
                          for _ in range(3)])
    logits = {d: list(gpt2.decode_multi(params, multi.to(d), cfg, caches[d])[0].float().cpu())
              for d, params in sides.items()}
    compare("decode_multi T=5", logits)
    # packed: three prompts in the 512 bucket
    toks = torch.zeros((1, 512), dtype=torch.long)
    off = sum(len(p) for p in prompts)
    toks[0, :off] = torch.tensor(sum(prompts, []))
    seg, pos = _packed_positions(torch, [len(p) for p in prompts], 512)
    logits = {d: list(gpt2.prefill_packed(params, toks.to(d), pos.to(d), seg.to(d), cfg)[0][
        0, :off].float().cpu()) for d, params in sides.items()}
    compare("prefill_packed", logits)
    # chunks of 256 of a 700-token prompt
    long = torch.from_numpy(rng.integers(0, cfg.vocab_size, 700))
    ccache = {d: gpt2.make_cache(cfg, 2, 1024, mode="int8", device=d) for d in sides}
    logits = {d: [] for d in sides}
    for start in range(0, 700, 256):
        n = min(256, 700 - start)
        chunk = torch.zeros((1, 256), dtype=torch.long)
        chunk[0, :n] = long[start:start + n]
        for d, params in sides.items():
            out, _ = gpt2.prefill_chunk(params, chunk.to(d), cfg, ccache[d], 1, start)
            logits[d].extend(out[0, :n].float().cpu())
    compare("prefill_chunk 3 x 256", logits)
    # paged: the two prompts, then four steps
    pools = {}
    logits = {d: [] for d in sides}
    for d, params in sides.items():
        pool = PagedKVPool.create(2, 9, 128, 2, 4, cfg.num_heads, cfg.head_dim, mode="int8",
                                  device=d, dtype=torch.bfloat16)
        pool.assign_pages(0, [5, 1, 7]).assign_pages(1, [3, 8])
        for slot, prompt in enumerate(prompts[:2]):
            out, kvs = gpt2.prefill_with_kv(params, torch.tensor([prompt], device=d),
                                            torch.arange(len(prompt), device=d)[None], cfg)
            for layer, (k, v) in enumerate(kvs):
                pool.append_prefill(layer, slot, k[0], v[0], 0)
        pools[d] = pool.set_lengths([len(p) for p in prompts[:2]])
    nxt = multi[:2, 0].clone()
    for _ in range(4):
        for d, params in sides.items():
            out, _ = gpt2.decode_step_paged(params, nxt.to(d), cfg, pools[d])
            logits[d].extend(out.float().cpu())
        nxt = torch.stack(logits["cpu"][-2:]).argmax(-1)
    compare("decode_step_paged x4", logits)
    torch.cuda.synchronize()
    parts = []
    for name, got, ref in results:
        finite = bool(torch.isfinite(got).all())
        err = float((got - ref).abs().max())
        # as card_vs_cpu: the sides round at the same points and sum in
        # another order, which can flip a bf16 or int8-KV rounding that two
        # layers carry on
        tol = 5e-2 * float(ref.abs().max())
        ok = checks.check(f"GPT-2 card vs cpu {name}", err, tol) and finite
        if not finite:
            checks.failed.append(f"GPT-2 card {name} not finite")
        same = got.argmax(-1) == ref.argmax(-1)
        parts.append(f"{name} {tuple(got.shape)} max_abs_err {err:.3e} (tol {tol:.3e}) greedy "
                     f"agreement {int(same.sum())}/{same.numel()} {'ok' if ok else 'FAIL'}")
    if not lengths_ok:
        checks.failed.append(f"GPT-2 card vs cpu: lengths {caches['cuda'].length.tolist()}, "
                             "expected [304, 41, 1034]")
    # an fp32 model on the card: the kernels take bf16 only
    f32 = gpt2.init_params(dataclasses.replace(cfg, dtype="float32", num_layers=1),
                           seed=SEED + 55, device="cuda")
    try:
        gpt2.prefill_with_kv(f32, torch.zeros((1, 64), dtype=torch.long, device="cuda"),
                             torch.arange(64, device="cuda")[None],
                             dataclasses.replace(cfg, dtype="float32", num_layers=1))
        raised = False
    except ValueError:
        raised = True
    if not raised:
        checks.failed.append("GPT-2 fp32 on the card did not raise from the kernels' dtype check")
    say(f"[phase 3 card vs cpu, GPT-2: 2 layers at 124M widths, bf16, int8 KV] "
        + "; ".join(parts) + f" | lengths after the decode steps "
        f"{'ok' if lengths_ok else 'FAIL'} | fp32 on the card raises: {raised} | "
        f"{time.perf_counter() - t0:.2f}s")
    del sides, caches, ccache, pools, card, f32
    torch.cuda.empty_cache()


def _counters():
    """(name -> kernel wrapper, the K8 wrapper): K8 also counts its
    chunk-mode launches apart."""
    from flash_attn_tpu_torch.ops import matmul as mm
    from flash_attn_tpu_torch.ops.decode import flash_decode_cuda
    from flash_attn_tpu_torch.ops.flash_bwd import flash_bwd_dkv_cuda, flash_bwd_dq_cuda
    from flash_attn_tpu_torch.ops.flash_fwd import flash_fwd_cuda
    from flash_attn_tpu_torch.ops.kv_append import kv_append_cuda
    from flash_attn_tpu_torch.ops.lse import lse_merge_cuda
    from flash_attn_tpu_torch.ops.paged_decode import paged_flash_decode_cuda
    from flash_attn_tpu_torch.parallel.rdma_ring import ring_attn_cuda

    return ({"K1": flash_decode_cuda, "K1m": lse_merge_cuda, "K2": kv_append_cuda,
             "K3": mm.matmul_int8_cuda, "K3g": mm.matmul_int8_grouped_cuda,
             "K4": flash_fwd_cuda, "K5": mm.matmul_w4a8_cuda,
             "K6": mm.matmul_int4_cuda, "K7": mm.matmul_w8a8_cuda,
             "K9": flash_bwd_dq_cuda, "K10": flash_bwd_dkv_cuda, "K11": ring_attn_cuda},
            paged_flash_decode_cuda)


def _reset_counts():
    wrappers, k8 = _counters()
    for fn in (*wrappers.values(), k8):
        fn.launches = 0
    k8.chunk_launches = k8.merges = 0
    wrappers["K1"].chunk_launches = wrappers["K1"].bshd_launches = 0
    wrappers["K1"].window_launches = wrappers["K1"].d256_launches = 0
    wrappers["K1"].view_launches = 0
    wrappers["K4"].seg_launches = wrappers["K4"].pos_launches = 0
    wrappers["K4"].window_launches = wrappers["K4"].d256_launches = 0
    wrappers["K4"].d64_launches = wrappers["K1"].d64_launches = k8.d64_launches = 0
    for key in ("K4", "K9", "K10"):
        wrappers[key].local_launches = 0
    wrappers["K4"].extra_launches = wrappers["K4"].dropout_launches = 0
    wrappers["K4"].alibi_launches = wrappers["K4"].probs_launches = 0
    wrappers["K4"].verify_launches = wrappers["K4"].masked_local_launches = 0
    wrappers["K1"].chunk_local_launches = k8.local_launches = k8.chunk_local_launches = 0
    for key in ("K9", "K10"):
        wrappers[key].window_launches = wrappers[key].d256_launches = 0
        wrappers[key].d64_launches = 0
        wrappers[key].opt_launches = wrappers[key].seg_launches = 0
        wrappers[key].alibi_launches = wrappers[key].ds_launches = 0


def _read_counts() -> dict:
    """Each kernel's launches; K1 split into decode mode (BHSD), chunk mode
    and BSHD, K8 into decode mode and chunk mode, K8's launches that
    merged their splits in the kernel ("K8 merges"), K4's launches with
    segment ids ("K4 seg"), with positions ("K4 pos"), with a window ("K4
    window"), at head_dim 256 ("K4 d256") or 64 ("K4 d64") and of a kLocal
    instance (window and softcap, "K4 local"), which are also counted in
    "K4", K1's (decode mode), K9's and K10's with a window, at head_dim
    256 and of a kLocal instance, and K1's and K1c's together ("K1 d64")
    and K8's and K8c's together ("K8 d64") at head_dim 64, and K9's and
    K10's at head_dim 64; K4's launches of a kExtra instance ("K4 extra"),
    K9's and K10's of a kOpt instance ("K9 opt", "K10 opt") and their
    segment-id launches ("K9 seg", "K10 seg"), K4's launches with
    dropout ("K4 dropout"), with ALiBi ("K4 alibi"), with return_softmax
    ("K4 probs") and with the clamped_verify flags ("K4 verify"), K9's
    and K10's with ALiBi ("K9 alibi", "K10 alibi") and K9's writing dS
    ("K9 ds"); the launches of the windowed instances of the serving
    paths: K4's masked kLocal one ("K4 local seg"), K1c's, K8's and K8c's
    kLocal ones ("K1c local", "K8 local", "K8c local")."""
    wrappers, k8 = _counters()
    counts = {k: fn.launches for k, fn in wrappers.items()}
    k1 = wrappers["K1"]
    counts["K1"] = k1.launches - k1.chunk_launches - k1.bshd_launches
    counts["K1c"] = k1.chunk_launches
    counts["K1b"] = k1.bshd_launches
    counts["K8"] = k8.launches - k8.chunk_launches
    counts["K8c"] = k8.chunk_launches
    counts["K8 merges"] = k8.merges
    counts["K4 seg"] = wrappers["K4"].seg_launches
    counts["K4 pos"] = wrappers["K4"].pos_launches
    counts["K4 window"] = wrappers["K4"].window_launches
    counts["K4 d256"] = wrappers["K4"].d256_launches
    counts["K1 window"] = k1.window_launches
    counts["K1 d256"] = k1.d256_launches
    counts["K1 view"] = k1.view_launches
    counts["K4 d64"] = wrappers["K4"].d64_launches
    counts["K1 d64"] = k1.d64_launches
    counts["K8 d64"] = k8.d64_launches
    counts["K4 local"] = wrappers["K4"].local_launches
    counts["K4 extra"] = wrappers["K4"].extra_launches
    counts["K4 dropout"] = wrappers["K4"].dropout_launches
    counts["K4 alibi"] = wrappers["K4"].alibi_launches
    counts["K4 probs"] = wrappers["K4"].probs_launches
    counts["K4 verify"] = wrappers["K4"].verify_launches
    counts["K9 ds"] = wrappers["K9"].ds_launches
    counts["K4 local seg"] = wrappers["K4"].masked_local_launches
    counts["K1c local"] = k1.chunk_local_launches
    counts["K8 local"] = k8.local_launches
    counts["K8c local"] = k8.chunk_local_launches
    for key in ("K9", "K10"):
        counts[f"{key} local"] = wrappers[key].local_launches
        counts[f"{key} window"] = wrappers[key].window_launches
        counts[f"{key} d256"] = wrappers[key].d256_launches
        counts[f"{key} d64"] = wrappers[key].d64_launches
        counts[f"{key} opt"] = wrappers[key].opt_launches
        counts[f"{key} seg"] = wrappers[key].seg_launches
        counts[f"{key} alibi"] = wrappers[key].alibi_launches
    return counts


def _prompts(vocab):
    import numpy as np

    rng = np.random.default_rng(SEED)
    lens = rng.integers(128, 1025, 8)
    return lens, [rng.integers(0, vocab, int(n)).tolist() for n in lens]


# decode dispatches left out of a run's step times (the first call of a
# body runs eagerly, the second on a side stream, the third captures it),
# and the steady steps of a profiled window
WARM_STEPS, WINDOW_STEPS = 4, 8


def _free(torch):
    """Return a dropped engine's memory: an engine and its captured bodies
    refer to each other, so only the cycle collector frees them."""
    gc.collect()
    torch.cuda.empty_cache()


def _decode_window(torch, eng):
    """WINDOW_STEPS steady decode steps of ``eng`` (burst 1) inside a
    torch.profiler window that records the card's activity alone, the card
    idle before and after: returns (wall ms, card busy ms, top 5 device
    activities).  Busy is the union of the card's activity intervals
    (utils/profiling.device_busy); the idle share is 1 - busy / wall.  The
    tracing itself lengthens the gaps between kernels, so the window's wall
    time exceeds the unprofiled steps'."""
    from flash_attn_tpu_torch.utils import profiling

    torch.cuda.synchronize()
    with profiling.trace(host=False) as prof:
        t0 = time.perf_counter()
        eng.run(max_steps=WINDOW_STEPS)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    busy, _ = profiling.device_busy(prof)
    return wall, busy / 1e3, profiling.top_kernels(prof, 5)


def serve(torch, checks, label, cfg, params, kv_mode, max_tokens, path, burst=1,
          window=False, packed=True, chunk=None, adapter=None, capacity=4096, prompts=None,
          max_batch=8, paged=False, spec=None, bank=None, adapters=None, mesh=None, waves=1):
    """One engine run of greedy requests (``max_batch``, ``capacity``) at
    ``burst``, through ``adapter`` (default: Llama's for ``cfg``) on
    ``prompts`` ((lengths, token lists); default ``_prompts``), in
    InferenceEngine (with ``spec``, its SpecConfig) or, with ``paged``,
    PagedInferenceEngine (pages of 128, no prefix cache); with ``mesh`` the
    cache is sharded over its sequence axis (the adapter must decode with
    the same mesh).  Every counter is set to 0 just before and read just after;
    each kernel in ``path`` must have launched.  The 8 prompts (3450
    tokens) go through one packed prefill, whose K4 calls carry segment
    ids (one a layer); with ``packed`` False the adapter has no
    prefill_packed and each prompt is prefilled alone (so also with
    ``bank``, a LoRA bank, request i under adapter ``adapters[i]``, its
    decode steps the engine's LoRA body); with ``chunk`` the
    engine has that prefill_chunk_size (so it does not pack), and K4's
    calls with positions must be one a layer and chunk; with ``waves`` 2
    the second half of the prompts is submitted after the engine's first
    step, so each half goes through a packed prefill of its own.  The step times
    leave out the first WARM_STEPS dispatches (warm-up and capture) and,
    with ``window`` (burst 1), the next WINDOW_STEPS, which run inside a
    profiler window.  Captured runs also time their decode graph replayed
    back to back (CUDA events): the card's time a decode position.
    Returns a dict of the run's counts, peak memory, tokens, ms and device
    ms a decode position, decode and prefill tokens/s, the window's
    numbers, the decode steps that ran between chunks, the run's decode
    dispatches, its wall seconds from the first submit and the decode
    body's calls."""
    import numpy as np

    from flash_attn_tpu_torch.engine import _graph
    from flash_attn_tpu_torch.engine.engine import InferenceEngine, PagedInferenceEngine
    from flash_attn_tpu_torch.models import llama

    t1 = time.perf_counter()
    lens, prompts = prompts or _prompts(cfg.vocab_size)
    adapter = adapter or llama.make_adapter(cfg)
    if not packed:
        adapter = dataclasses.replace(adapter, prefill_packed=None)
    if paged:
        eng = PagedInferenceEngine(params, adapter, max_batch=max_batch, capacity=capacity,
                                   page_size=128, kv_mode=kv_mode, device="cuda",
                                   decode_burst=burst)
    else:
        eng = InferenceEngine(params, adapter, max_batch=max_batch, capacity=capacity,
                              kv_mode=kv_mode, device="cuda", decode_burst=burst,
                              prefill_chunk_size=chunk, spec=spec, lora_bank=bank, mesh=mesh)
    between = [0]  # decode steps run while a prompt is mid-way through its chunks
    step = eng._do_decode_step

    def counted_step():
        between[0] += bool(getattr(eng, "_prefilling", ()))
        step()

    eng._do_decode_step = counted_step
    _reset_counts()
    t_run = time.perf_counter()
    first = len(prompts) // waves
    reqs = [eng.submit(p, max_tokens=max_tokens, **({"adapter": adapters[i]} if bank else {}))
            for i, p in enumerate(prompts[:first])]
    if waves > 1:
        eng.run(max_steps=1)
        reqs += [eng.submit(p, max_tokens=max_tokens) for p in prompts[first:]]
    m = eng.metrics

    def now():
        return np.array([m.decode_tokens, m.decode_seconds, m.steps])

    win = None
    eng.run(max_steps=WARM_STEPS)
    if window:
        win = _decode_window(torch, eng)
    skip = now()
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_run
    counts = _read_counts()
    dispatches = m.steps
    tokens, secs, steps = now() - skip
    tokens, steps = int(tokens), int(steps)
    good = all(r.done and len(r.generated) == max_tokens
               and all(0 <= t < cfg.vocab_size for t in r.generated) for r in reqs)
    if not good:
        checks.failed.append(f"{label}: a request did not finish with {max_tokens} valid tokens")
    idle = [k for k in path if counts[k] <= 0]
    if idle:
        checks.failed.append(f"{label}: kernels {idle} were not launched: {counts}")
    n_chunks = sum(-(-len(p) // chunk) for p in prompts if len(p) > chunk) if chunk else 0
    packs = int(packed and not chunk and bank is None) * waves  # a bank never packs
    want = {"packed prefills": packs, "K4 seg": cfg.num_layers * packs,
            "K4 pos": cfg.num_layers * (n_chunks if chunk else packs)}
    got = {"packed prefills": getattr(eng, "packed_prefills", 0), "K4 seg": counts["K4 seg"],
           "K4 pos": counts["K4 pos"]}
    if got != want:
        checks.failed.append(f"{label}: prefill paths {got}, expected {want}")
    body = (eng._verify_jit if spec else eng._burst_jit if burst > 1
            else eng._decode_lora_jit if bank else eng._decode_jit)
    rounds = eng._verify_jit.calls if spec else 0
    dev_ms = None
    if _graph._enabled:
        if body.graph is None:
            checks.failed.append(f"{label}: the decode body was not captured")
        else:
            dev_ms = cuda_ms(torch, body.graph.replay, iters=10, warmup=2) / burst
    peak = torch.cuda.max_memory_allocated() / 2**30
    pos_ms = 1e3 * secs / max(steps * burst, 1)
    prefill_tok_s = m.prefill_tokens / max(m.prefill_seconds, 1e-9)
    how = (f"{n_chunks} chunks of {chunk}, {between[0]} decode steps between them"
           if chunk else f"{packs} packed call{'s' if packs > 1 else ''}" if packs
           else "one prompt a call")
    say(f"[{label}] {len(prompts)} requests, prompts {lens.tolist()}, {max_tokens} tokens each: "
        f"{'ok' if good else 'FAIL'} | prefill {prefill_tok_s:.1f} tok/s ({how}) | decode "
        f"{tokens / max(secs, 1e-9):.1f} tok/s, {pos_ms:.3f} ms a decode position "
        f"({steps} dispatches of {burst} after {WARM_STEPS}"
        + (f" and {WINDOW_STEPS} profiled steps" if window else "") + ")"
        + (f", the card {dev_ms:.3f} ms a position (graph replays)" if dev_ms else "")
        + f" | max_memory_allocated {peak:.2f} GiB | {time.perf_counter() - t1:.2f}s")
    say("kernels " + json.dumps({"run": label, **counts}))
    calls = body.calls
    # the engine is held by its bodies and by counted_step's cells: drop
    # them all before collecting
    del eng, body, step, counted_step
    _free(torch)
    return dict(counts=counts, peak=peak, tokens=[r.generated for r in reqs], pos_ms=pos_ms,
                tok_s=tokens / max(secs, 1e-9), dev_ms=dev_ms, window=win,
                prefill_tok_s=prefill_tok_s, dispatches=dispatches, rounds=rounds, wall=wall,
                calls=calls)


def serve_ways(torch, checks, smi, label, cfg, params, max_tokens, path, eager_window):
    """The same 8 prompts three ways, fp8 KV: eager (``disable_graphs()``)
    and captured at decode_burst 1, and captured at decode_burst 4.  All
    three must give equal tokens.  Prints each one's ms a decode position,
    decode tokens/s, host ms a position (wall time less the card's time of
    the captured step's graph, which runs the same kernels) and the idle
    share that those two give (1 - card / wall), and the idle share of the
    profiled windows (the eager one with ``eager_window``).  Returns the captured burst-1 run's counts, peak
    and tokens."""
    from flash_attn_tpu_torch.engine._graph import disable_graphs

    with disable_graphs():
        eager = serve(torch, checks, f"{label}, eager", cfg, params, "fp8", max_tokens, path,
                      window=eager_window)
    graph = serve(torch, checks, label, cfg, params, "fp8", max_tokens, path, window=True)
    burst = serve(torch, checks, f"{label}, burst 4", cfg, params, "fp8", max_tokens, path,
                  burst=4)
    for name, run in (("eager", eager), ("burst 4", burst)):
        bad = [i for i, (a, b) in enumerate(zip(run["tokens"], graph["tokens"])) if a != b]
        if bad:
            checks.failed.append(f"{label}: {name} tokens differ from the captured run's in "
                                 f"requests {bad}")
    ways = (("eager", eager, graph["dev_ms"]), ("captured", graph, graph["dev_ms"]),
            ("captured burst 4", burst, burst["dev_ms"]))
    parts = []
    for name, run, dev in ways:
        host = (f", host {run['pos_ms'] - dev:.3f} ms, idle share unprofiled "
                f"{1 - dev / run['pos_ms']:.4f}") if dev else ""
        parts.append(f"{name} {run['pos_ms']:.3f} ms a position, {run['tok_s']:.1f} tok/s{host}")
    same = all(a == b for run in (eager, burst) for a, b in zip(run["tokens"], graph["tokens"]))
    say(f"[{label}: eager / captured / burst 4] {smi} | " + "; ".join(parts)
        + f" | tokens equal in all three: {same}")
    for name, run in (("eager", eager), ("captured", graph)):
        if run["window"] is None:
            continue
        wall, busy, top = run["window"]
        say(f"  {name} window of {WINDOW_STEPS} steps ({smi}), torch.profiler: wall {wall:.3f} "
            f"ms, card busy {busy:.3f} ms, idle share {1 - busy / wall:.4f}; top 5: "
            + ", ".join(f"{n[:60]} {ms:.3f} ms x{c}" for n, ms, c in top))
    return graph


def serve_prefill_ways(torch, checks, smi, params, packed_run, runs):
    """Phase 4's prefill paths beside its packed run (``packed_run``, the
    captured fp8 one): the same prompts with one prompt a prefill call (an
    adapter without prefill_packed; 16 tokens), and with
    prefill_chunk_size 512 (32 tokens; its counts go into ``runs``).
    Prints each one's prefill tokens/s and the share of greedy tokens the
    one-prompt run has in common with the packed one (their arithmetic
    differs, so equality is not required)."""
    from flash_attn_tpu_torch.models import llama

    cfg, base = llama.LLAMA3_8B, ("K1", "K1m", "K2", "K3", "K4")
    one = serve(torch, checks, RUN_8B_ONE, cfg, params, "fp8", 16, base, packed=False)
    chunked = serve(torch, checks, RUN_CHUNK, cfg, params, "fp8", 32, base, chunk=512)
    runs[RUN_CHUNK] = chunked["counts"]
    same = sum(a == b for r, want in zip(one["tokens"], packed_run["tokens"])
               for a, b in zip(r, want))
    say(f"[phase 4 prefill: packed / one prompt a call / chunks of 512] {smi} | prefill "
        f"{packed_run['prefill_tok_s']:.1f} / {one['prefill_tok_s']:.1f} / "
        f"{chunked['prefill_tok_s']:.1f} tok/s | greedy tokens of the one-prompt run equal to "
        f"the packed run's {same}/{8 * 16}")


def serve_recapture(torch, checks, smi):
    """A head changed in place between two waves of one engine (as a
    training step changes it) must bring the decode body back to its eager
    calls and a new capture: Llama-3 at 8B widths, 2 layers, int8 weights,
    fp8 KV, the 8 prompts, 8 tokens.  Wave 2 runs on the negated head and
    must give the tokens of a fresh eager engine on it, and other tokens
    than wave 1."""
    from flash_attn_tpu_torch.engine._graph import disable_graphs
    from flash_attn_tpu_torch.engine.engine import InferenceEngine
    from flash_attn_tpu_torch.models import llama

    t1 = time.perf_counter()
    cfg = dataclasses.replace(llama.LLAMA3_8B, num_layers=2)
    params = llama.init_params(cfg, seed=SEED + 23, device="cuda", quantize="int8")
    _, prompts = _prompts(cfg.vocab_size)

    def wave(eng):
        reqs = [eng.submit(p, max_tokens=8) for p in prompts]
        eng.run()
        return [r.generated for r in reqs]

    def engine():
        return InferenceEngine(params, llama.make_adapter(cfg), max_batch=8, capacity=4096,
                               kv_mode="fp8", device="cuda")

    eng = engine()
    first = wave(eng)
    graph = eng._decode_jit.graph
    params["lm_head"].neg_()
    second = wave(eng)
    recaptured = eng._decode_jit.graph is not None and eng._decode_jit.graph is not graph
    with disable_graphs():
        want = wave(engine())
    if not (recaptured and second == want and second != first):
        checks.failed.append(f"{RUN_RECAPTURE}: recaptured {recaptured}, tokens equal to a "
                             f"fresh eager engine's {second == want}, other than wave 1's "
                             f"{second != first}")
    del eng, graph, params
    _free(torch)
    say(f"[{RUN_RECAPTURE}] {smi} | re-captured after the head changed in place: "
        f"{recaptured}, wave 2 equal to a fresh eager engine {second == want}, differs from "
        f"wave 1 {second != first} | {time.perf_counter() - t1:.2f}s")


def serve_sampled(torch, checks, smi, params):
    """A short captured run at temperature 0.8, top_k 50 (Llama-3-8B int8,
    fp8 KV, the 8 prompts, 8 tokens): two seeds, each twice.  Every token
    must be valid and both runs of one seed equal (the engine's generator is
    registered with each captured graph)."""
    from flash_attn_tpu_torch.engine.engine import InferenceEngine
    from flash_attn_tpu_torch.engine.sampler import SamplingParams
    from flash_attn_tpu_torch.models import llama

    t1 = time.perf_counter()
    cfg, n_tok = llama.LLAMA3_8B, 8
    _, prompts = _prompts(cfg.vocab_size)
    runs = {}
    for seed in (0, 1):
        for rep in range(2):
            eng = InferenceEngine(params, llama.make_adapter(cfg), max_batch=8, capacity=4096,
                                  kv_mode="fp8", rng_seed=seed, device="cuda",
                                  sampling=SamplingParams(temperature=0.8, top_k=50))
            reqs = [eng.submit(p, max_tokens=n_tok) for p in prompts]
            eng.run()
            runs[seed, rep] = [r.generated for r in reqs]
            if eng._decode_jit.graph is None:
                checks.failed.append(f"{RUN_SAMPLED}: the decode body was not captured")
            if not all(len(t) == n_tok and all(0 <= x < cfg.vocab_size for x in t)
                       for t in runs[seed, rep]):
                checks.failed.append(f"{RUN_SAMPLED}: seed {seed}: invalid tokens")
            del eng
            _free(torch)
    repeat = [runs[s, 0] == runs[s, 1] for s in (0, 1)]
    if not all(repeat):
        checks.failed.append(f"{RUN_SAMPLED}: two runs of one seed differ: {repeat}")
    torch.cuda.empty_cache()
    say(f"[{RUN_SAMPLED}] {smi} | 8 requests, {n_tok} tokens, seeds 0 and 1 twice each: "
        f"valid, each seed's two runs equal {repeat}, the seeds' tokens differ "
        f"{runs[0, 0] != runs[1, 0]} | {time.perf_counter() - t1:.2f}s")


def serve_paged(torch, checks, params, burst=1, cfg=None, run=None, prefix_len=512,
                capacity=4096, n_tok=32):
    """Phase 7: Llama-3-8B (phase 4's int8 params; or ``cfg``, a Llama
    config, as the run ``run``) through
    PagedInferenceEngine with prefix caching, fp8 KV, pages of 128,
    max_batch 8, ``capacity`` (4096), ``n_tok`` (32) greedy tokens per
    request, decode bodies captured, at ``burst``.  Traffic: a
    ``prefix_len``-token shared prefix (512: 4 full pages) and 16 distinct
    suffixes of 64-512 tokens, all from the seed, in two waves of 8.  Wave
    1 is admitted in one round before any prefill, so all 8 miss and the
    first to prefill donates the prefix pages; wave 2, submitted after
    wave 1 completes, must hit 8 times and prefill only its suffixes (K8
    chunk mode, no K4): K8c once a layer for every 128 tokens of each
    suffix's bucket.  Counters are set to 0 before each wave and read after
    it; returns the two waves' counts summed and the tokens."""
    import numpy as np

    from flash_attn_tpu_torch.engine.engine import PagedInferenceEngine
    from flash_attn_tpu_torch.engine.scheduler import bucket_length
    from flash_attn_tpu_torch.models import llama

    t1 = time.perf_counter()
    run = run or RUN_PAGED
    label = run if burst == 1 else f"{run}, burst {burst}"
    cfg = cfg or llama.LLAMA3_8B
    rng = np.random.default_rng(SEED + 7)
    prefix = rng.integers(0, cfg.vocab_size, prefix_len).tolist()
    suffix_lens = rng.integers(64, 513, 16)
    prompts = [prefix + rng.integers(0, cfg.vocab_size, int(n)).tolist() for n in suffix_lens]
    torch.cuda.reset_peak_memory_stats()
    eng = PagedInferenceEngine(params, llama.make_adapter(cfg), max_batch=8, capacity=capacity,
                               page_size=128, kv_mode="fp8", prefix_cache=True, device="cuda",
                               decode_burst=burst)
    m = eng.metrics
    waves, total, tokens, steps = [], {}, [], 0
    for w in range(2):
        before = (m.prefill_tokens, m.prefill_seconds, m.decode_tokens, m.decode_seconds, m.steps)
        _reset_counts()
        reqs = [eng.submit(p, max_tokens=n_tok) for p in prompts[8 * w:8 * (w + 1)]]
        eng.run()
        torch.cuda.synchronize()
        counts = _read_counts()
        total = {k: total.get(k, 0) + n for k, n in counts.items()}
        tokens += [r.generated for r in reqs]
        good = all(r.done and len(r.generated) == n_tok
                   and all(0 <= t < cfg.vocab_size for t in r.generated) for r in reqs)
        if not good:
            checks.failed.append(f"{label} wave {w + 1}: a request did not finish "
                                 f"with {n_tok} valid tokens")
        after = (m.prefill_tokens, m.prefill_seconds, m.decode_tokens, m.decode_seconds, m.steps)
        d = [x - y for x, y in zip(after, before)]
        steps += d[4]
        waves.append(counts)
        say(f"  wave {w + 1}: suffixes {suffix_lens[8 * w:8 * (w + 1)].tolist()} | prefix "
            f"hits {eng.prefix.hits}, misses {eng.prefix.misses} so far | prefill "
            f"{d[0] / max(d[1], 1e-9):.1f} tok/s ({d[0]} tokens in {d[1]:.3f}s) | decode "
            f"{d[2] / max(d[3], 1e-9):.1f} tok/s ({1e3 * d[3] / max(d[4] * burst, 1):.3f} ms a position) | "
            f"{'ok' if good else 'FAIL'} | kernels {json.dumps(counts)}")
    free, resident = eng.alloc.free_count, eng.prefix.resident_pages
    num_pages = eng.pool.num_pages
    for name, got, want in (("prefix hits", eng.prefix.hits, 8),
                            ("prefix misses", eng.prefix.misses, 8),
                            ("K4 launches in wave 2", waves[1]["K4"], 0),
                            ("free pages after both waves", free, num_pages - 1 - resident)):
        if got != want:
            checks.failed.append(f"{label}: {name} {got}, expected {want}")
    for key in ("K8", "K8c", "K1m", "K3", "K4"):
        if total[key] <= 0:
            checks.failed.append(f"{label}: kernel {key} was not launched: {total}")
    # wave 2's suffix prefills: the prefix's full pages are cached, each
    # suffix runs in 128-token pieces of its bucket
    cached = prefix_len // 128 * 128
    pieces = sum(-(-min(bucket_length(len(p) - cached), capacity - cached) // 128)
                 for p in prompts[8:])
    if waves[1]["K8c"] != cfg.num_layers * pieces:
        checks.failed.append(f"{label}: K8c launched {waves[1]['K8c']} times in wave 2, "
                             f"expected {cfg.num_layers} x {pieces} suffix pieces")
    body = eng._burst_jit if burst > 1 else eng._decode_jit
    if body.graph is None:
        checks.failed.append(f"{label}: the decode body was not captured")
    # each decode-mode call is one launch of K8 that merges its own splits:
    # K1m serves only K8c's calls (at most one each)
    if burst == 1 and total["K8"] != cfg.num_layers * steps:
        checks.failed.append(f"{label}: K8 launched {total['K8']} times in {steps} decode "
                             f"steps, expected {cfg.num_layers} a step")
    if total["K8 merges"] != total["K8"] or total["K1m"] > total["K8c"]:
        checks.failed.append(f"{label}: decode-mode K8 calls are not one launch each "
                             f"(K8 {total['K8']}, merged in the kernel {total['K8 merges']}, "
                             f"K1m {total['K1m']}, K8c {total['K8c']})")
    peak = torch.cuda.max_memory_allocated() / 2**30
    say(f"[{label}] 16 requests in two waves, {n_tok} tokens each: hits "
        f"{eng.prefix.hits}, misses {eng.prefix.misses}, resident pages {resident}, free "
        f"{free} of {num_pages - 1} | decode {m.decode_tokens / max(m.decode_seconds, 1e-9):.1f} "
        f"tok/s ({1e3 * m.decode_seconds / max(m.steps * burst, 1):.3f} ms a decode position) | "
        f"max_memory_allocated {peak:.2f} GiB | {time.perf_counter() - t1:.2f}s")
    say("kernels " + json.dumps({"run": label, **total}))
    del eng, body
    _free(torch)
    return total, tokens


def _draft_3b(torch):
    """A draft model at Llama-3.2-3B's published widths (hidden 3072, 28
    layers, 24 heads, 8 KV heads, head_dim 128, intermediate 8192, vocab
    128256, tied embeddings, rope_theta 500000), bf16 random weights from
    the seed: (config, params) on the card."""
    from flash_attn_tpu_torch.models import llama

    cfg = dataclasses.replace(llama.LLAMA3_8B, hidden=3072, intermediate=8192, num_layers=28,
                              num_heads=24, num_kv_heads=8, tie_embeddings=True)
    return cfg, llama.init_params(cfg, seed=SEED + 19, device="cuda")


def serve_spec(torch, checks, params, plain_tokens):
    """Phase 9: speculative decoding (num_draft 4) on phase 4's params,
    Llama-3-8B int8, the same 8 greedy prompts and 32 tokens, max_batch 8,
    capacity 4096: (a) n-gram drafts (ngram 2), fp8 KV; (b) a self-draft
    (the draft is the target) with the target's KV unquantized, so both
    caches hold the same values and every draft should be accepted up to
    rounding; (c) a draft at Llama-3.2-3B widths, fp8 KV.  The draft scans
    and verify steps replay from CUDA graphs.  Every counter is set to 0
    just before each run and read just after; the verify rounds are the
    calls of the engine's verify body.  Returns {run label: counts}."""
    from flash_attn_tpu_torch.engine.engine import InferenceEngine, SpecConfig
    from flash_attn_tpu_torch.models import llama

    cfg, n_tok, K = llama.LLAMA3_8B, 32, 4
    lens, prompts = _prompts(cfg.vocab_size)
    adapter = llama.make_adapter(cfg)
    runs = {}
    for label in (RUN_SPEC_NGRAM, RUN_SPEC_SELF, RUN_SPEC_3B):
        t1 = time.perf_counter()
        kv_mode, path = "fp8", ("K1c", "K1m", "K3", "K4")
        if label == RUN_SPEC_NGRAM:
            spec = SpecConfig(num_draft=K, ngram=2)
        elif label == RUN_SPEC_SELF:
            kv_mode, path = "none", path + ("K1", "K2")
            spec = SpecConfig(num_draft=K, draft_params=params, draft_adapter=adapter)
        else:
            path += ("K1", "K2")
            dcfg, dparams = _draft_3b(torch)
            spec = SpecConfig(num_draft=K, draft_params=dparams,
                              draft_adapter=llama.make_adapter(dcfg))
        eng = InferenceEngine(params, adapter, max_batch=8, capacity=4096, kv_mode=kv_mode,
                              spec=spec, device="cuda")
        _reset_counts()
        reqs = [eng.submit(p, max_tokens=n_tok) for p in prompts]
        eng.run()
        torch.cuda.synchronize()
        counts = _read_counts()
        runs[label] = counts
        m, snap = eng.metrics, eng.metrics.snapshot()
        rounds = eng._verify_jit.calls
        if eng._verify_jit.graph is None or (
                spec.draft_adapter is not None and eng._draft_scan_jit.graph is None):
            checks.failed.append(f"{label}: the verify step or draft scan was not captured")
        good = all(r.done and len(r.generated) == n_tok
                   and all(0 <= t < cfg.vocab_size for t in r.generated) for r in reqs)
        if not good:
            checks.failed.append(f"{label}: a request did not finish with {n_tok} valid tokens")
        if m.spec_steps <= 0:
            checks.failed.append(f"{label}: no verify step")
        if eng.packed_prefills != 1 or counts["K4 seg"] != cfg.num_layers:
            checks.failed.append(f"{label}: {eng.packed_prefills} packed prefills, K4 with "
                                 f"segment ids {counts['K4 seg']}, expected 1 and "
                                 f"{cfg.num_layers}")
        if counts["K1c"] != cfg.num_layers * rounds:
            checks.failed.append(f"{label}: K1c launched {counts['K1c']} times in "
                                 f"{rounds} verify rounds, expected {cfg.num_layers} each")
        idle = [k for k in path if counts[k] <= 0]
        if idle:
            checks.failed.append(f"{label}: kernels {idle} were not launched: {counts}")
        accept = snap["spec_draft_acceptance"]
        if label == RUN_SPEC_SELF and accept < 0.5:
            checks.failed.append(f"{label}: draft acceptance {accept} < 0.5")
        same = [sum(a == b for a, b in zip(r.generated, want))
                for r, want in zip(reqs, plain_tokens)]
        diverge = [next((i for i, (a, b) in enumerate(zip(r.generated, want)) if a != b), None)
                   for r, want in zip(reqs, plain_tokens)]
        emitted = sum(len(r.generated) - 1 for r in reqs)  # the first token is the prefill's
        say(f"[{label}] 8 requests, {n_tok} tokens each: {'ok' if good else 'FAIL'} | decode "
            f"{emitted / max(m.decode_seconds, 1e-9):.1f} tok/s, "
            f"{1e3 * m.decode_seconds / max(m.steps, 1):.3f} ms per round ({rounds} verify "
            f"rounds of {m.steps}) | spec_tokens_per_step {snap['spec_tokens_per_step']}, draft "
            f"acceptance {accept} | tokens equal to phase 4's plain run {sum(same)}/{8 * n_tok}, "
            f"first divergence per request {diverge} | max_memory_allocated "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | {time.perf_counter() - t1:.2f}s")
        say("kernels " + json.dumps({"run": label, **counts}))
        del eng, spec
        _free(torch)
    return runs


def _fresh_model(torch, cfg, **quant):
    """Params on the card from the seed, with the peak-memory count reset
    first so the run's peak includes them."""
    from flash_attn_tpu_torch.models import llama

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = llama.init_params(cfg, seed=SEED, device="cuda", **quant)
    torch.cuda.synchronize()
    return params, time.perf_counter() - t0


def phase_serve(torch, checks, smi):
    """The main paths through the engine, one model on the card at a time,
    the decode bodies captured in CUDA graphs:
    4. Llama-3-8B, int8 weights, fp8 KV three ways (eager, captured,
       captured burst 4) with profiled windows, each with one packed
       prefill; one prompt a prefill call and chunks of 512
       (serve_prefill_ways); then int8 KV; 32 tokens; then a short
       stochastic run (serve_sampled);
    5. Llama-3-8B, W4A8 layers + W8A8 head, fused, fp8 KV, 32 tokens;
    6. Llama-3-70B, int4 g=128 layers + W8A8 head, fused, fp8 KV three
       ways, 16 tokens.
    Returns {run label: that run's launch counts}."""
    from flash_attn_tpu_torch.models import llama

    runs = {}
    base = ("K1", "K1m", "K2", "K4")

    params, secs = _fresh_model(torch, llama.LLAMA3_8B, quantize="int8")
    say(f"  8B params (int8 weights, bf16 embeddings and head) on the card in "
        f"{secs:.2f}s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    run = serve_ways(torch, checks, smi, RUN_8B_INT8, llama.LLAMA3_8B, params, 64,
                     base + ("K3",), eager_window=True)
    runs[RUN_8B_INT8], plain_tokens = run["counts"], run["tokens"]
    serve_prefill_ways(torch, checks, smi, params, run, runs)
    label = "phase 4 serve Llama-3-8B int8, int8 KV"
    runs[label] = serve(torch, checks, label, llama.LLAMA3_8B, params, "int8", 32,
                        base + ("K3",))["counts"]
    serve_sampled(torch, checks, smi, params)
    serve_recapture(torch, checks, smi)
    runs[RUN_PAGED], paged_tokens = serve_paged(torch, checks, params)
    _, burst_tokens = serve_paged(torch, checks, params, burst=4)
    if burst_tokens != paged_tokens:
        checks.failed.append(f"{RUN_PAGED}: burst 4 tokens differ from burst 1's")
    say(f"[{RUN_PAGED}: burst 4 against burst 1] tokens equal: {burst_tokens == paged_tokens}")
    runs.update(serve_spec(torch, checks, params, plain_tokens))
    del params

    params, secs = _fresh_model(torch, llama.LLAMA3_8B, quantize="w4a8",
                                group_size=128, head_mode="w8a8", fuse=True)
    say(f"  8B params (W4A8 g=128 fused layers, W8A8 head) on the card in "
        f"{secs:.2f}s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    runs[RUN_8B_W4A8] = serve(torch, checks, RUN_8B_W4A8, llama.LLAMA3_8B, params, "fp8", 32,
                              base + ("K5", "K7"))["counts"]
    del params

    params, secs = _fresh_model(torch, llama.LLAMA3_70B, quantize="int4",
                                group_size=128, head_mode="w8a8", fuse=True)
    say(f"  70B params (int4 g=128 fused layers, W8A8 head, bf16 embeddings) on the "
        f"card in {secs:.2f}s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    run = serve_ways(torch, checks, smi, RUN_70B, llama.LLAMA3_70B, params, 32,
                     base + ("K6", "K7"), eager_window=False)
    runs[RUN_70B] = run["counts"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    if peak > MAX_70B_GIB:
        checks.failed.append(f"70B serve peak {peak:.2f} GiB > {MAX_70B_GIB} GiB")
    say(f"[{RUN_70B}] peak {peak:.2f} GiB against the {MAX_70B_GIB} GiB limit (a packed 4096 "
        f"prefill: all 80 layers' K/V and the [4096, 128256] fp32 logits)")
    runs.update(phase_tp(torch, checks, smi, params))
    del params
    _free(torch)
    return runs


MAX_GEMMA_GIB = 75.0            # the Gemma-2-9B serve fails above this peak
GEMMA_LONG = 6000                # the long prompt: the window cuts in prefill and decode


def _gemma_prompts(vocab):
    """Seven prompts of 128-1024 tokens and one of GEMMA_LONG, from the seed."""
    import numpy as np

    rng = np.random.default_rng(SEED + 40)
    lens = np.append(rng.integers(128, 1025, 7), GEMMA_LONG)
    return lens, [rng.integers(0, vocab, int(n)).tolist() for n in lens]


def phase_gemma(torch, checks, smi, size="9B"):
    """Phase 10: Gemma-2-9B (42 layers, random weights from the seed), int8
    weights, fp8 KV, max_batch 8, capacity 8192: 8 greedy requests (seven
    prompts of 128-1024 tokens and one of GEMMA_LONG, so the 4096 window
    cuts in prefill and in decode), 32 tokens each, one prompt a prefill
    call (the adapter has no packed prefill, as in JAX), eager
    (``disable_graphs()``) and captured: equal tokens, decode ms a position
    and tokens/s, the card's ms a position (the captured run also the idle
    share and top 5 kernels of a torch.profiler window of WINDOW_STEPS
    steps), prefill tokens/s, peak memory
    against MAX_GEMMA_GIB, and the launches (K4 42 a prefill call, all
    kLocal at head_dim 256, half of them windowed; K1 at 256, K2 and K1m
    42 a decode step, half of K1's windowed).  Then int8 KV, 16 tokens.
    Phase 14 (``size`` "27B"): the same for Gemma-2-27B (46 layers, head_dim
    128: K4's kLocal instance beside Llama's, 46 a prefill call, 23
    windowed, none at 256; K1 at 128, 23 of 46 a step windowed), without
    the int8 KV run.  Returns {run label: that run's launch counts}."""
    from flash_attn_tpu_torch.engine._graph import disable_graphs
    from flash_attn_tpu_torch.models import gemma2

    cfg, run = (gemma2.GEMMA2_27B, RUN_GEMMA27) if size == "27B" else (gemma2.GEMMA2_9B,
                                                                       RUN_GEMMA)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = gemma2.init_params(cfg, seed=SEED, device="cuda", quantize="int8")
    torch.cuda.synchronize()
    say(f"  Gemma-2-{size} params (int8 weights, bf16 embeddings = the tied head) on the card in "
        f"{time.perf_counter() - t0:.2f}s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    prompts = _gemma_prompts(cfg.vocab_size)
    adapter = gemma2.make_adapter(cfg)
    d256 = cfg.head_dim == 256
    path = ("K1", "K1m", "K2", "K3", "K4", "K4 local", "K4 window", "K1 window") + (
        ("K4 d256", "K1 d256") if d256 else ())
    kw = dict(packed=False, adapter=adapter, capacity=8192, prompts=prompts)
    with disable_graphs():
        eager = serve(torch, checks, f"{run}, eager", cfg, params, "fp8", 32, path, **kw)
    graph = serve(torch, checks, run, cfg, params, "fp8", 32, path, window=True, **kw)
    same = eager["tokens"] == graph["tokens"]
    if not same:
        checks.failed.append(f"{run}: eager tokens differ from the captured run's")
    L, n_req = cfg.num_layers, len(prompts[0])
    for name, one in (("eager", eager), ("captured", graph)):
        c, steps = one["counts"], one["dispatches"]
        want = {"K4": L * n_req, "K4 local": L * n_req, "K4 d256": L * n_req * d256,
                "K4 window": L // 2 * n_req, "K1": L * steps, "K1 d256": L * steps * d256,
                "K1 window": L // 2 * steps, "K2": L * steps, "K1m": L * steps}
        got = {key: c[key] for key in want}
        if got != want:
            checks.failed.append(f"{run}, {name}: launches {got}, expected {want}")
    peak = graph["peak"]
    if peak > MAX_GEMMA_GIB:
        checks.failed.append(f"{run}: peak {peak:.2f} GiB > {MAX_GEMMA_GIB} GiB")
    c, dev = graph["counts"], graph["dev_ms"]
    say(f"[{run}: eager / captured] {smi} | decode eager {eager['pos_ms']:.3f} ms a "
        f"position ({eager['tok_s']:.1f} tok/s), captured {graph['pos_ms']:.3f} ms a position "
        f"({graph['tok_s']:.1f} tok/s), the card {dev:.3f} ms a position (graph replays) | "
        f"prefill {graph['prefill_tok_s']:.1f} tok/s (one prompt a call, prompts "
        f"{prompts[0].tolist()}) | peak {peak:.2f} GiB (limit {MAX_GEMMA_GIB}: the 8192-bucket "
        f"prefill's fp32 [1, 8192, 256128] logits take 7.8 GiB) | launches (captured): K4 "
        f"{c['K4']} = {L} x {n_req} prefill calls ({c['K4 local']} kLocal, {c['K4 window']} "
        f"windowed, {c['K4 d256']} at head_dim 256), K1 {c['K1']} = {L} x {graph['dispatches']} "
        f"steps ({c['K1 window']} windowed), K2 {c['K2']}, K1m {c['K1m']}, K3 {c['K3']} | "
        f"tokens equal eager / captured: {same}")
    wall, busy, top = graph["window"]
    say(f"  captured window of {WINDOW_STEPS} steps ({smi}), torch.profiler: wall {wall:.3f} ms, "
        f"card busy {busy:.3f} ms, idle share {1 - busy / wall:.4f}; top 5: "
        + ", ".join(f"{n[:60]} {ms:.3f} ms x{cnt}" for n, ms, cnt in top))
    runs = {run: c}
    if size == "9B":
        label = "phase 10 serve Gemma-2-9B int8, int8 KV"
        runs[label] = serve(torch, checks, label, cfg, params, "int8", 16, path, **kw)["counts"]
    del params
    _free(torch)
    return runs


def _launches_exact(checks, label, got, want):
    """Fail unless each count of ``want`` is ``got``'s."""
    have = {key: got[key] for key in want}
    if have != want:
        checks.failed.append(f"{label}: launches {have}, expected {want}")
    return have == want


def phase_qwen(torch, checks, smi):
    """Phase 16: Qwen-2-7B (28 layers, 28 query heads over 4 KV heads, the
    qkv bias; random weights from the seed), int8 weights, fp8 KV, capacity
    4096, phase 4's 8 prompts (of its vocabulary): eager, captured and
    captured at burst 4 (equal tokens; serve_ways, 32 tokens); one prompt
    a prefill call (16 tokens) and chunks of 512 (32), their prefill
    tokens/s beside the packed call's; the paged engine with prefix caching
    (serve_paged: two waves of 8 sharing a 512-token prefix, hits and
    misses printed); n-gram speculation (4 drafts, 32 tokens).  Launches
    exact: K4 28 a packed prefill call, K1 = K2 = K1m 28 a decode step, K1c
    28 a verify round, K8 28 a paged step.  Peak memory printed (the fp32
    head copy alone is 2.03 GiB).  Returns {run label: counts}."""
    from flash_attn_tpu_torch.engine.engine import SpecConfig
    from flash_attn_tpu_torch.models import llama

    cfg = llama.QWEN2_7B
    L = cfg.num_layers
    params, secs = _fresh_model(torch, cfg, quantize="int8")
    say(f"  Qwen-2-7B params (int8 weights with bf16 qkv biases, bf16 embeddings and head) "
        f"on the card in {secs:.2f}s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    base = ("K1", "K1m", "K2", "K3", "K4")
    runs = {}
    graph = serve_ways(torch, checks, smi, RUN_QWEN, cfg, params, 32, base, eager_window=False)
    steps = graph["dispatches"]
    _launches_exact(checks, RUN_QWEN, graph["counts"], {
        "K4": L, "K4 seg": L, "K1": L * steps, "K2": L * steps, "K1m": L * steps})
    runs[RUN_QWEN] = graph["counts"]
    one = serve(torch, checks, RUN_QWEN_ONE, cfg, params, "fp8", 16, base, packed=False)
    chunked = serve(torch, checks, RUN_QWEN_CHUNK, cfg, params, "fp8", 32, base, chunk=512)
    say(f"[phase 16 prefill: packed / one prompt a call / chunks of 512] {smi} | prefill "
        f"{graph['prefill_tok_s']:.1f} / {one['prefill_tok_s']:.1f} / "
        f"{chunked['prefill_tok_s']:.1f} tok/s")
    runs[RUN_QWEN_PAGED], _ = serve_paged(torch, checks, params, cfg=cfg, run=RUN_QWEN_PAGED)
    spec = serve(torch, checks, RUN_QWEN_SPEC, cfg, params, "fp8", 32,
                 ("K1c", "K1m", "K3", "K4"), spec=SpecConfig(num_draft=4, ngram=2))
    _launches_exact(checks, RUN_QWEN_SPEC, spec["counts"], {"K1c": L * spec["rounds"]})
    runs[RUN_QWEN_SPEC] = spec["counts"]
    say(f"[{RUN_QWEN}] {smi} | launches: K4 {graph['counts']['K4']} = {L} x 1 packed call, K1 "
        f"{graph['counts']['K1']} = K2 = K1m = {L} x {steps} steps, K1c {spec['counts']['K1c']} "
        f"= {L} x {spec['rounds']} verify rounds, K8 {runs[RUN_QWEN_PAGED]['K8']} (= {L} a "
        f"paged step) | peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del params
    _free(torch)
    return runs


# phase 25's prompts: two groups of four, each group packed into one call
# (a packed call holds at most the capacity, 8192 tokens), the first of
# each past the 4096-token window
MISTRAL_PROMPTS = ((4200, 1800, 1200, 700), (4300, 1600, 1300, 800))
MAX_MISTRAL_GIB = 75.0          # the Mistral-7B serve fails above this peak


def phase_mistral(torch, checks, smi):
    """Phase 25: Mistral-7B-v0.1's published config at full size
    (``mistral_7b``: 32 layers, a 4096-token sliding window; random int8
    weights from the seed), fp8 KV, capacity 8192, max_batch 8, 32 greedy
    tokens a request, every way with at least two sequences past the
    window in prefill and in decode (printed): packed prefill
    (``MISTRAL_PROMPTS``, two groups, one packed call each), eager against
    captured (tokens equal); chunks of 512 (all eight prompts at once); the
    paged engine with prefix caching (serve_paged: a 4096-token shared
    prefix and suffixes of 64-512, two waves of 8, hits printed); n-gram
    speculation with 4 drafts.  Launches exact, every one on a windowed
    instance: K4's masked kLocal instance 32 a packed call (32 a chunk),
    K1 32 a decode step (all windowed), K1c 32 a verify round, K8 32 a
    paged step, K8c 32 a 128-token piece of a suffix prefill.  Prints ms a
    position, prefill tokens/s and the peak with the card's name and power
    limit.  Returns {run label: counts}."""
    import numpy as np

    from flash_attn_tpu_torch.engine._graph import disable_graphs
    from flash_attn_tpu_torch.engine.engine import SpecConfig

    t0 = time.perf_counter()
    cfg = mistral_7b()
    L, W = cfg.num_layers, cfg.sliding_window
    params, secs = _fresh_model(torch, cfg, quantize="int8")
    say(f"  Mistral-7B-v0.1 params (int8 weights, bf16 embeddings and head) on the card in "
        f"{secs:.2f}s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    rng = np.random.default_rng(SEED + 25)
    lens = np.array([n for group in MISTRAL_PROMPTS for n in group])
    prompts = (lens, [rng.integers(0, cfg.vocab_size, int(n)).tolist() for n in lens])
    n_tok, base = 32, ("K1", "K1m", "K2", "K3", "K4")
    kw = dict(capacity=8192, prompts=prompts)
    past = (int((lens > W).sum()), int((lens + n_tok - 1 > W).sum()))
    with disable_graphs():
        eager = serve(torch, checks, RUN_MISTRAL_EAGER, cfg, params, "fp8", n_tok, base,
                      waves=2, **kw)
    graph = serve(torch, checks, RUN_MISTRAL, cfg, params, "fp8", n_tok, base, waves=2, **kw)
    chunked = serve(torch, checks, RUN_MISTRAL_CHUNK, cfg, params, "fp8", n_tok, base,
                    chunk=512, **kw)
    spec = serve(torch, checks, RUN_MISTRAL_SPEC, cfg, params, "fp8", n_tok,
                 ("K1c", "K1m", "K3", "K4"), spec=SpecConfig(num_draft=4, ngram=2), waves=2,
                 **kw)
    # serve_paged resets the peak: the serve runs' first
    peak = max(run["peak"] for run in (eager, graph, chunked, spec))
    paged, _ = serve_paged(torch, checks, params, cfg=cfg, run=RUN_MISTRAL_PAGED,
                           prefix_len=4096, capacity=8192, n_tok=n_tok)
    peak = max(peak, torch.cuda.max_memory_allocated() / 2**30)
    bad = [i for i, (a, b) in enumerate(zip(eager["tokens"], graph["tokens"])) if a != b]
    if bad:
        checks.failed.append(f"{RUN_MISTRAL}: eager tokens differ from the captured run's in "
                             f"requests {bad}")
    n_chunks = sum(-(-int(n) // 512) for n in lens if n > 512)
    for label, run, want in (
            (RUN_MISTRAL_EAGER, eager, {"K4": 2 * L, "K4 local seg": 2 * L,
                                        "K1": L * eager["dispatches"],
                                        "K1 window": L * eager["dispatches"]}),
            (RUN_MISTRAL, graph, {"K4": 2 * L, "K4 local seg": 2 * L,
                                  "K1": L * graph["dispatches"],
                                  "K1 window": L * graph["dispatches"],
                                  "K2": L * graph["dispatches"], "K1m": L * graph["dispatches"]}),
            (RUN_MISTRAL_CHUNK, chunked, {"K4 local seg": L * n_chunks,
                                          "K1 window": chunked["counts"]["K1"]}),
            (RUN_MISTRAL_SPEC, spec, {"K4 local seg": 2 * L, "K1c": L * spec["rounds"],
                                      "K1c local": L * spec["rounds"]})):
        _launches_exact(checks, label, run["counts"], want)
    _launches_exact(checks, RUN_MISTRAL_PAGED, paged, {"K8 local": paged["K8"],
                                                        "K8c local": paged["K8c"]})
    if min(past) < 2:
        checks.failed.append(f"{RUN_MISTRAL}: {past} sequences past the window in prefill and "
                             "decode, expected at least 2 of each")
    if peak > MAX_MISTRAL_GIB:
        checks.failed.append(f"{RUN_MISTRAL}: peak {peak:.2f} GiB > {MAX_MISTRAL_GIB}")
    say(f"[{RUN_MISTRAL}] {smi} | prompts {lens.tolist()}: {past[0]} past the {W}-token "
        f"window in prefill, {past[1]} in decode (the paged run's 16 all past it) | eager / "
        f"captured {eager['pos_ms']:.3f} / {graph['pos_ms']:.3f} ms a position ("
        f"{graph['dev_ms'] or float('nan'):.3f} on the card), tokens equal {not bad}; chunks of "
        f"512 {chunked['pos_ms']:.3f}; n-gram "
        f"{spec['pos_ms']:.3f} ms a round ({spec['rounds']} rounds) | prefill tok/s: packed "
        f"{graph['prefill_tok_s']:.1f} (2 calls), chunks of 512 {chunked['prefill_tok_s']:.1f} "
        f"| launches: K4 local seg {graph['counts']['K4 local seg']} = {L} x 2 packed calls, "
        f"{chunked['counts']['K4 local seg']} = {L} x {n_chunks} chunks; K1 "
        f"{graph['counts']['K1']} = {L} x {graph['dispatches']} steps, all windowed; K1c "
        f"{spec['counts']['K1c']} = {L} x {spec['rounds']} rounds; K8 {paged['K8']}, K8c "
        f"{paged['K8c']}, all windowed | peak {peak:.2f} GiB | {time.perf_counter() - t0:.2f}s")
    runs = {RUN_MISTRAL: graph["counts"], RUN_MISTRAL_CHUNK: chunked["counts"],
            RUN_MISTRAL_SPEC: spec["counts"], RUN_MISTRAL_PAGED: paged}
    del params
    _free(torch)
    return runs


MAX_MIXTRAL_GIB = 75.0          # the Mixtral-8x7B serve fails above this peak


def phase_mixtral(torch, checks, smi):
    """Phase 17: Mixtral-8x7B (32 layers, 8 experts of 4096 x 14336, top 2;
    random weights from the seed, drawn and quantized one projection at a
    time: the bf16 model does not fit the card), int8 experts and
    attention, fp8 KV, capacity 4096, phase 4's 8 prompts in one packed
    prefill call: eager and captured (equal tokens, 32 tokens), with ms a
    decode position, the card's ms a position (the captured graph replayed)
    and its share of the wall time, and the idle share in a torch.profiler
    window of 8 captured steps; n-gram speculation through decode_multi (4
    drafts, 32 tokens); the paged engine without prefix caching (the
    adapter has no suffix prefill, as in JAX).  Every expert runs for every
    token (JAX's exact form), so launches are exact: K3 = 32 x (4 + 3 x 8)
    = 896 a decode step or packed call, K1 = K2 = K1m 32 a step, K4 32 a
    packed call, K1c 32 a verify round, K8 32 a paged step.  Peak under
    MAX_MIXTRAL_GIB.  Returns {run label: counts}."""
    from flash_attn_tpu_torch.engine._graph import disable_graphs
    from flash_attn_tpu_torch.engine.engine import SpecConfig
    from flash_attn_tpu_torch.models import mixtral as mx

    cfg = mx.MIXTRAL_8X7B
    L, per_layer = cfg.num_layers, 4 + 3 * cfg.num_experts
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = mx.init_params(cfg, seed=SEED, device="cuda", quantize="int8")
    torch.cuda.synchronize()
    weight_bytes = sum(x.numel() * x.element_size() for blk in params["blocks"]
                       for w in [blk[n] for n in ("wq", "wk", "wv", "wo")]
                       + [ex[n] for ex in blk["experts"] for n in ex] for x in w)
    say(f"  Mixtral-8x7B params (int8 experts and attention, bf16 router, embeddings and head) "
        f"drawn and quantized on the card in {time.perf_counter() - t0:.2f}s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB ({weight_bytes / 2**30:.2f} GiB of "
        f"int8 projections and their scales, all read by every decode step)")
    kw = dict(adapter=mx.make_adapter(cfg))
    path = ("K1", "K1m", "K2", "K3", "K4")
    with disable_graphs():
        eager = serve(torch, checks, f"{RUN_MIXTRAL}, eager", cfg, params, "fp8", 32, path, **kw)
    graph = serve(torch, checks, RUN_MIXTRAL, cfg, params, "fp8", 32, path, window=True, **kw)
    same = eager["tokens"] == graph["tokens"]
    if not same:
        checks.failed.append(f"{RUN_MIXTRAL}: eager tokens differ from the captured run's")
    for name, run in (("eager", eager), ("captured", graph)):
        steps = run["dispatches"]
        _launches_exact(checks, f"{RUN_MIXTRAL}, {name}", run["counts"], {
            "K3": L * per_layer * (steps + 1), "K4": L, "K4 seg": L, "K1": L * steps,
            "K2": L * steps, "K1m": L * steps})
    spec = serve(torch, checks, RUN_MIXTRAL_SPEC, cfg, params, "fp8", 32,
                 ("K1c", "K1m", "K3", "K4"), spec=SpecConfig(num_draft=4, ngram=2), **kw)
    _launches_exact(checks, RUN_MIXTRAL_SPEC, spec["counts"], {"K1c": L * spec["rounds"]})
    paged = serve(torch, checks, RUN_MIXTRAL_PAGED, cfg, params, "fp8", 32, ("K3", "K4", "K8"),
                  paged=True, packed=False, **kw)
    n_req = len(paged["tokens"])
    _launches_exact(checks, RUN_MIXTRAL_PAGED, paged["counts"], {
        "K8": L * paged["dispatches"], "K4": L * n_req})
    peak = max(run["peak"] for run in (eager, graph, spec, paged))
    if peak > MAX_MIXTRAL_GIB:
        checks.failed.append(f"{RUN_MIXTRAL}: peak {peak:.2f} GiB > {MAX_MIXTRAL_GIB} GiB")
    c, dev, steps = graph["counts"], graph["dev_ms"], graph["dispatches"]
    wall, busy, top = graph["window"]
    say(f"[{RUN_MIXTRAL}: eager / captured] {smi} | decode eager {eager['pos_ms']:.3f} ms a "
        f"position ({eager['tok_s']:.1f} tok/s), captured {graph['pos_ms']:.3f} ms a position "
        f"({graph['tok_s']:.1f} tok/s), the card {dev:.3f} ms a position (graph replays; "
        f"{dev / graph['pos_ms']:.4f} of the wall, its weights at "
        f"{weight_bytes / (dev * 1e-3) / 1e12:.3f} TB/s), idle share in the profiled window "
        f"{1 - busy / wall:.4f} | prefill {graph['prefill_tok_s']:.1f} tok/s (one packed call) "
        f"| n-gram {spec['tok_s']:.1f} tok/s, paged {paged['pos_ms']:.3f} ms a position | peak "
        f"{peak:.2f} GiB (limit {MAX_MIXTRAL_GIB}) | launches (captured): K3 {c['K3']} = {L} x "
        f"{per_layer} x ({steps} steps + 1 packed call), K4 {c['K4']}, K1 {c['K1']} = K2 = K1m "
        f"= {L} x {steps}; K1c {spec['counts']['K1c']} = {L} x {spec['rounds']} verify rounds; "
        f"K8 {paged['counts']['K8']} = {L} x {paged['dispatches']} paged steps | tokens equal "
        f"eager / captured: {same}")
    say(f"  captured window of {WINDOW_STEPS} steps ({smi}), torch.profiler: wall {wall:.3f} ms, "
        f"card busy {busy:.3f} ms, idle share {1 - busy / wall:.4f}; top 5: "
        + ", ".join(f"{n[:60]} {ms:.3f} ms x{cnt}" for n, ms, cnt in top))
    runs = {RUN_MIXTRAL: c, RUN_MIXTRAL_SPEC: spec["counts"],
            RUN_MIXTRAL_PAGED: paged["counts"]}
    del params
    _free(torch)
    return runs


MIXTRAL_TRAIN_LAYERS = 2   # phase 24: Mixtral-8x7B's widths, 2 of its 32 layers
MIXTRAL_PACKED_STEPS = 2   # phase 24's steps on packed documents
MIXTRAL_CKPT_STEP = 3      # phase 24 saves its state after this step


def _mixtral_train_bound(torch, cfg, params, seq):
    """(ms, a line) of a Mixtral training step's least time at B=1, S=``seq``:
    the bf16 GEMMs (every expert for every token, and the attention
    projections; four passes: the forward, the backward's two products and
    remat's rerun) and the attention products (K4's two a pass, twice;
    K9's three; K10's four: 11 products of 2*D flops a causal pair and
    head) at BF16_FLOPS_PER_S; the fp32 head and router (three products
    each) at F32_FLOPS_PER_S; AdamW's bytes (each bf16 param, gradient and
    two moments read once, the param and moments written once) at
    HBM_BYTES_PER_S."""
    from flash_attn_tpu_torch.utils import train

    h, L, E, F = cfg.hidden, cfg.num_layers, cfg.num_experts, cfg.intermediate
    qd, kvd = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    dense = 2 * (2 * h * qd + 2 * h * kvd + 3 * h * F * E)  # a token, a layer
    gemms = 4 * L * seq * dense
    attn = 11 * 2 * cfg.head_dim * cfg.num_heads * L * seq * (seq + 1) // 2
    f32 = 3 * 2 * seq * h * (cfg.vocab_size + L * E)
    n_params = sum(p.numel() for p in train.param_leaves(params))
    adam = 7 * 2 * n_params
    parts = ((gemms + attn) / BF16_FLOPS_PER_S, f32 / F32_FLOPS_PER_S, adam / HBM_BYTES_PER_S)
    line = (f"bf16 GEMMs {gemms / 1e12:.3f} TFLOP ({gemms / 4 / L / 1e12:.3f} a layer a pass; "
            f"{3 * gemms / 4 / L / 1e12:.3f} a layer without remat's rerun) and attention "
            f"{attn / 1e12:.3f} TFLOP ({1e3 * parts[0]:.3f} ms at {BF16_FLOPS_PER_S / 1e12:g} "
            f"TFLOP/s), the fp32 head and router {f32 / 1e12:.3f} TFLOP ({1e3 * parts[1]:.3f} ms "
            f"at {F32_FLOPS_PER_S / 1e12:g}), AdamW {adam / 1e9:.3f} GB ({1e3 * parts[2]:.3f} ms "
            f"at {HBM_BYTES_PER_S / 1e12:g} TB/s)")
    return 1e3 * sum(parts), line


def phase_mixtral_train(torch, checks, smi):
    """Phase 24: Mixtral at 8x7B widths and MIXTRAL_TRAIN_LAYERS layers
    (bf16 params and moments from the seed), B=1, S=TRAIN_SEQ, TRAIN_STEPS
    AdamW steps of the default TrainConfig (remat on) through
    ``mixtral.forward``: losses finite and falling, peak under
    MAX_TRAIN_GIB, launches exact (K9 = K10 = one a layer a step, K4 two:
    remat reruns it), the median step beside its bound.  After step
    MIXTRAL_CKPT_STEP the state (params and AdamW moments and count) goes
    through utils/checkpoint.TrainCheckpointManager into a temporary
    directory and comes back by restore_latest as a new tree on the card,
    every leaf bit-equal to the live state's; after the straight run, the
    restored state takes the remaining steps, whose losses are printed
    beside the straight run's (bitwise or not; held to TRAIN_LOSS_TOL).
    Then MIXTRAL_PACKED_STEPS steps on phase 19's packed documents (K4's
    masked instance, K9's and K10's kOpt instances), launches exact.
    Returns {run: counts}."""
    import shutil
    import tempfile

    from flash_attn_tpu_torch.models import mixtral as mx
    from flash_attn_tpu_torch.utils import checkpoint, train

    t1 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(mx.MIXTRAL_8X7B, num_layers=MIXTRAL_TRAIN_LAYERS)
    params = mx.init_params(cfg, seed=SEED + 82, device="cuda")
    bound_ms, line = _mixtral_train_bound(torch, cfg, params, TRAIN_SEQ)
    say(f"  phase 24 bound: {line}")
    fwd = lambda p, tokens, remat: mx.forward(p, tokens, cfg, remat=remat)  # noqa: E731
    n = MIXTRAL_TRAIN_LAYERS * TRAIN_STEPS
    ckpt_dir = tempfile.mkdtemp(prefix="mixtral_ckpt_")
    resumed = {}

    def save_and_restore(i, p, state, step_fn, tok, tgt):
        if i != MIXTRAL_CKPT_STEP:
            return
        t0 = time.perf_counter()
        mgr = checkpoint.TrainCheckpointManager(ckpt_dir)
        live = {"params": p, "opt": state}
        mgr.save(i, live)
        mgr.close()
        t_save = time.perf_counter() - t0
        step, back = checkpoint.TrainCheckpointManager(ckpt_dir).restore_latest(like=live)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0 - t_save
        a, b = train.param_leaves(back), train.param_leaves(live)
        same = step == i and len(a) == len(b) and all(
            x == y if isinstance(x, int) else
            x.device == y.device and x.dtype == y.dtype and torch.equal(x, y)
            for x, y in zip(a, b))
        if not same:
            checks.failed.append(f"phase 24: the checkpoint of step {i} is not restored bitwise")
        nbytes = sum(x.numel() * x.element_size() for x in b if not isinstance(x, int))
        resumed.update(state=back, fn=step_fn, batch=(tok, tgt), same=same, step=step,
                       line=f"{nbytes / 1e9:.3f} GB saved in {t_save:.2f}s, restored in "
                            f"{t_load:.2f}s")

    try:
        counts = _train_run(torch, checks, smi, RUN_MIXTRAL_TRAIN, params, fwd, cfg.vocab_size,
                            TRAIN_SEQ, SEED + 83, {"K9": n, "K10": n, "K4": 2 * n}, t1,
                            bound_ms=bound_ms, after_step=save_and_restore)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    straight = LOSSES[RUN_MIXTRAL_TRAIN][MIXTRAL_CKPT_STEP:]
    if resumed:
        back, step_fn = resumed["state"], resumed["fn"]
        p, st = back["params"], back["opt"]
        again = []
        for _ in range(TRAIN_STEPS - MIXTRAL_CKPT_STEP):
            p, st, m = step_fn(p, st, *resumed["batch"])
            again.append(float(m["loss"]))
        bitwise = again == straight
        err = max(abs(a - b) / abs(b) for a, b in zip(again, straight))
        checks.check("phase 24 resumed losses (relative)", err, TRAIN_LOSS_TOL)
        say(f"  phase 24 checkpoint ({smi}): TrainCheckpointManager after step "
            f"{MIXTRAL_CKPT_STEP}, {resumed['line']}, every leaf, moment and the count "
            f"bit-equal: {resumed['same']} | resumed steps {MIXTRAL_CKPT_STEP + 1}-{TRAIN_STEPS} "
            f"losses {again} against the straight run's {straight}: bitwise {bitwise}, "
            f"relative err {err:.3e} (tol {TRAIN_LOSS_TOL:g})")
        del back, p, st, m, resumed["state"]
    else:
        checks.failed.append(f"phase 24: no checkpoint after step {MIXTRAL_CKPT_STEP}")
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    n = MIXTRAL_TRAIN_LAYERS * MIXTRAL_PACKED_STEPS
    want = {"K9": n, "K10": n, "K9 opt": n, "K10 opt": n, "K9 seg": n, "K10 seg": n,
            "K4": 2 * n, "K4 seg": 2 * n}
    packed = _train_run(torch, checks, smi, RUN_MIXTRAL_PACKED_TRAIN, params,
                        _packed_train_fwd(torch, cfg, PACKED_DOCS, mx.forward), cfg.vocab_size,
                        TRAIN_SEQ, SEED + 84, want, t1, steps=MIXTRAL_PACKED_STEPS)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return {RUN_MIXTRAL_TRAIN: counts, RUN_MIXTRAL_PACKED_TRAIN: packed}


def _llama_train_bound(torch, cfg, params, seq, pairs):
    """(ms, a line) of a Llama-layout training step's least time at B=1,
    S=``seq`` with ``pairs`` live attention pairs a head: the bf16 GEMMs of
    the layers (four passes: the forward, the backward's two products and
    remat's rerun) and attention's 11 products of 2*D flops a live pair
    and head (K4's two a pass, twice; K9's three; K10's four) at
    BF16_FLOPS_PER_S; the fp32 head (three products) at F32_FLOPS_PER_S;
    AdamW's bytes (each bf16 param, gradient and two moments read once,
    the param and moments written once) at HBM_BYTES_PER_S."""
    from flash_attn_tpu_torch.utils import train

    h, L, F = cfg.hidden, cfg.num_layers, cfg.intermediate
    qd, kvd = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    dense = 2 * (2 * h * qd + 2 * h * kvd + 3 * h * F)  # a token, a layer
    gemms = 4 * L * seq * dense
    attn = 11 * 2 * cfg.head_dim * cfg.num_heads * L * pairs
    f32 = 3 * 2 * seq * h * cfg.vocab_size
    n_params = sum(p.numel() for p in train.param_leaves(params))
    adam = 7 * 2 * n_params
    parts = ((gemms + attn) / BF16_FLOPS_PER_S, f32 / F32_FLOPS_PER_S, adam / HBM_BYTES_PER_S)
    line = (f"bf16 GEMMs {gemms / 1e12:.3f} TFLOP and attention {attn / 1e12:.3f} TFLOP on "
            f"{pairs} live pairs a head ({1e3 * parts[0]:.3f} ms at "
            f"{BF16_FLOPS_PER_S / 1e12:g} TFLOP/s), the fp32 head {f32 / 1e12:.3f} TFLOP "
            f"({1e3 * parts[1]:.3f} ms at {F32_FLOPS_PER_S / 1e12:g}), AdamW {adam / 1e9:.3f} GB "
            f"({1e3 * parts[2]:.3f} ms at {HBM_BYTES_PER_S / 1e12:g} TB/s)")
    return 1e3 * sum(parts), line


def phase_mistral_train(torch, checks, smi):
    """Phase 26: Mistral-7B-v0.1's published config (``mistral_7b``: 32
    layers, window 4096; bf16 params and AdamW moments from the seed,
    7.24 B parameters) trained on packed documents: B=1,
    S=MISTRAL_TRAIN_SEQ holding MISTRAL_TRAIN_DOCS (segment ids 1-4, RoPE
    positions restarting a document; the first document, 4800 tokens, runs
    past the window), TRAIN_STEPS AdamW steps of the default TrainConfig
    (remat on) through ``llama.forward(segment_ids=...)``: losses finite
    and falling, peak under MAX_TRAIN_GIB, the median step beside its
    bound, and the launches exact: K4's masked kLocal instance (its twin
    with the window on the indices) twice a layer a step (remat reruns
    it), K9's and K10's kLocal and kOpt instances (their twin) once.
    Returns {run: counts}."""
    from flash_attn_tpu_torch.models import llama
    from flash_attn_tpu_torch.ops import flash_fwd as ff

    t1 = time.perf_counter()
    cfg = mistral_7b()
    params, _ = _fresh_model(torch, cfg)
    seg, _ = _packed_positions(torch, MISTRAL_TRAIN_DOCS, MISTRAL_TRAIN_SEQ)
    pairs = int(ff.live_pairs(ff.Masks(seg, seg, None, None), True, MISTRAL_TRAIN_SEQ,
                              MISTRAL_TRAIN_SEQ, "cpu", (MISTRAL_WINDOW - 1, -1)).sum())
    bound_ms, line = _llama_train_bound(torch, cfg, params, MISTRAL_TRAIN_SEQ, pairs)
    say(f"  phase 26 bound: {line}")
    n = cfg.num_layers * TRAIN_STEPS
    want = {"K9": n, "K10": n, "K9 local": n, "K10 local": n, "K9 opt": n, "K10 opt": n,
            "K9 seg": n, "K10 seg": n, "K9 window": n, "K10 window": n, "K4": 2 * n,
            "K4 local seg": 2 * n, "K4 seg": 2 * n, "K4 pos": 0}
    counts = _train_run(torch, checks, smi, RUN_MISTRAL_TRAIN, params,
                        _packed_train_fwd(torch, cfg, MISTRAL_TRAIN_DOCS), cfg.vocab_size,
                        MISTRAL_TRAIN_SEQ, SEED + 97, want, t1, bound_ms=bound_ms)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return {RUN_MISTRAL_TRAIN: counts}


# each training run's median step (ms) and its losses, by run label
STEP_MS, LOSSES = {}, {}


def _train_run(torch, checks, smi, run, params, fwd, vocab, seq, seed, want, t1, batch=1,
               bound_ms=None, steps=TRAIN_STEPS, after_step=None):
    """``steps`` AdamW steps (the default TrainConfig: lr 3e-4, weight
    decay 0.1, clip 1.0, remat on) of ``params`` on one batch of B=``batch``,
    S=``seq`` from ``seed`` whose targets are its tokens shifted by one:
    losses finite and falling, peak under MAX_TRAIN_GIB, and each count of
    ``want``.  The counters are set to 0 just before the steps and read
    just after.  ``bound_ms`` (a step's least time, worked out by the
    caller) is printed beside the median step.  ``after_step(i, params,
    state, step_fn, tok, tgt)`` runs after step i (from 1), outside its
    time, and launches no kernel.  The losses are kept in LOSSES[run].
    Returns the counts."""
    import numpy as np

    from flash_attn_tpu_torch.utils import train

    n_params = sum(p.numel() for p in train.param_leaves(params))
    init_fn, step_fn = train.make_train_step(fwd, train.TrainConfig())
    state = init_fn(params)
    data = np.random.default_rng(seed).integers(0, vocab, (batch, seq + 1))
    data = torch.from_numpy(data).to("cuda")
    tok, tgt = data[:, :-1], data[:, 1:]
    torch.cuda.synchronize()
    say(f"  params ({n_params / 1e9:.3f} B, bf16) and AdamW state on the card in "
        f"{time.perf_counter() - t1:.2f}s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    _reset_counts()
    losses, norms, secs_per_step = [], [], []
    for i in range(steps):
        t0 = time.perf_counter()
        params, state, m = step_fn(params, state, tok, tgt)
        torch.cuda.synchronize()
        secs_per_step.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        if after_step is not None:
            after_step(i + 1, params, state, step_fn, tok, tgt)
    counts = _read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    step_ms = 1e3 * float(np.median(secs_per_step[1:]))
    STEP_MS[run], LOSSES[run] = step_ms, losses
    for key, n in want.items():
        if counts[key] != n:
            checks.failed.append(f"{run}: {key} launched {counts[key]} times, expected {n}")
    good = all(np.isfinite(losses)) and losses[-1] < losses[0]
    if not good:
        checks.failed.append(f"{run}: losses not finite and falling: {losses}")
    if peak > MAX_TRAIN_GIB:
        checks.failed.append(f"{run}: peak {peak:.2f} GiB > {MAX_TRAIN_GIB} GiB")
    say(f"[{run}] {smi} | losses {[round(x, 6) for x in losses]} grad_norm "
        f"{[round(x, 4) for x in norms]} {'ok' if good else 'FAIL'} | step ms "
        f"{[round(1e3 * x, 3) for x in secs_per_step]}, median of steps 2-{steps} "
        f"{step_ms:.3f} ms, {batch * seq / step_ms * 1e3:.1f} tokens/s"
        + ("" if bound_ms is None else f" (bound {bound_ms:.3f} ms, {bound_ms / step_ms:.3f} of "
           "the step)") + f" | max_memory_allocated "
        f"{peak:.2f} GiB (limit {MAX_TRAIN_GIB}) | launches " + ", ".join(
            f"{key} {counts[key]}" for key in want) + f" | {time.perf_counter() - t1:.2f}s")
    say("kernels " + json.dumps({"run": run, **counts}))
    del params, state, m
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def phase_train(torch, checks, smi):
    """Phase 8: Llama-3 at 8B widths and TRAIN_LAYERS layers (bf16 params
    from the seed; at 32 layers the bf16 params, gradients and two moments
    take 64.2 GB), B=1, S=TRAIN_SEQ; K9 and K10 launch once a layer a
    step, K4 twice (remat reruns it)."""
    from flash_attn_tpu_torch.models import llama

    t1 = time.perf_counter()
    cfg = dataclasses.replace(llama.LLAMA3_8B, num_layers=TRAIN_LAYERS)
    params, _ = _fresh_model(torch, cfg)
    n = TRAIN_LAYERS * TRAIN_STEPS
    return _train_run(torch, checks, smi, RUN_TRAIN, params, _train_fwd(cfg), cfg.vocab_size,
                      TRAIN_SEQ, SEED + 14, {"K9": n, "K10": n, "K4": 2 * n}, t1)


# --- phase 18: the C entry points at full width ----------------------------

ABI_REPEATS = 3  # calls of each entry point a case (the first warms; all counted)


class _AbiCall:
    """One case of the C entry points: random host buffers (numpy; bf16 as
    its int16 bits), an fp32 mask from _rand_bias, and the struct that
    points at them.  ``lens``: varlen sequences (else dense B x S)."""

    def __init__(self, torch, g, abi, *, lens=None, B=1, S=0, H=32, Hk=8, D=128, code=1,
                 mask=None, causal=True, rate=DROP_RATE, seed=DROP_SEED):
        import ctypes

        import numpy as np

        self.torch, self.abi = torch, abi
        self.code, self.lens, self.causal = code, lens, causal
        self.dtype = {0: torch.float32, 1: torch.bfloat16, 2: torch.float16}[code]
        self.H, self.Hk, self.D = H, Hk, D
        if lens is not None:
            total = sum(lens)
            qs, ks, self.lse_shape = (total, H, D), (total, Hk, D), (H, total)
        else:
            qs, ks, self.lse_shape = (B, S, H, D), (B, S, Hk, D), (B, H, S)

        def host(shape):
            x = torch.randn(shape, generator=g, device="cuda").to(self.dtype).cpu()
            return (x.view(torch.int16) if code == 1 else x).numpy()
        self.q, self.k, self.v, self.dout = host(qs), host(ks), host(ks), host(qs)
        self.out, self.dq = np.zeros_like(self.q), np.zeros_like(self.q)
        self.dk, self.dv = np.zeros_like(self.k), np.zeros_like(self.v)
        self.lse = np.zeros(self.lse_shape, np.float32)
        self.mask = None if mask is None else _rand_bias(torch, g, mask).cpu().numpy()
        c = abi.FattAttnCall()
        c.struct_size = ctypes.sizeof(abi.FattAttnCall)
        c.q, c.k, c.v = self.q.ctypes.data, self.k.ctypes.data, self.v.ctypes.data
        c.out = self.out.ctypes.data
        c.lse = self.lse.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        c.num_heads, c.num_heads_k, c.head_dim, c.dtype = H, Hk, D, code
        c.dropout_rate, c.dropout_seed, c.is_causal = rate, seed, causal
        if self.mask is not None:
            self.dims = (ctypes.c_int64 * self.mask.ndim)(*self.mask.shape)
            c.attn_mask, c.mask_dims, c.mask_ndim = self.mask.ctypes.data, self.dims, self.mask.ndim
        if lens is not None:
            self.cu = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
            c.cu_seqlens_q = c.cu_seqlens_k = self.cu.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
            c.batch, c.total_q, c.total_k = len(lens), total, total
            c.seqlen_q = c.seqlen_k = max(lens)
        else:
            c.batch, c.seqlen_q, c.seqlen_k = B, S, S
        c.dout, c.lse_in = self.dout.ctypes.data, c.lse
        c.dq, c.dk, c.dv = self.dq.ctypes.data, self.dk.ctypes.data, self.dv.ctypes.data
        self.call = c
        self.rate, self.seed = rate, seed

    def run(self, lib, backward):
        """One call of the forward or backward entry point, host to host:
        (ok, seconds)."""
        import ctypes

        name = f"fatt_attn_{'varlen_' if self.lens else ''}{'bwd' if backward else 'fwd'}"
        t0 = time.perf_counter()
        ok = getattr(lib, name)(ctypes.byref(self.call))
        return ok, time.perf_counter() - t0

    def tensor(self, x):
        """A host buffer as the tensor the executor makes of it on the card
        (fp16 computed as bf16)."""
        t = self.torch.from_numpy(x).view(self.dtype).cuda()
        return t.to(self.torch.bfloat16) if self.code == 2 else t

    def args(self):
        """(q, k, v, causal, masks, bias as a [B, H, Sq, Sk] view, dropout)
        as the executor hands them to K4, K9 and K10."""
        from flash_attn_tpu_torch.ops import flash_fwd as ff

        torch = self.torch
        q, k, v = (self.tensor(x) for x in (self.q, self.k, self.v))
        masks, causal = None, self.causal
        mask = None if self.mask is None else torch.from_numpy(self.mask).cuda()
        if self.lens is not None:
            q, k, v = q[None], k[None], v[None]
            masks, causal = _varlen_masks(torch, self.lens), False
        B, Sq, H, _ = q.shape
        bias = None if mask is None else ff.bias4(mask, B, H, Sq, k.shape[1])
        return q, k, v, causal, masks, bias, ff.Dropout(self.rate, self.seed)

    def label(self):
        kind = {1: "bf16", 2: "fp16", 0: "fp32"}[self.code]
        shape = (f"varlen {len(self.lens)} sequences in {sum(self.lens)}" if self.lens
                 else f"B={self.q.shape[0]} S={self.q.shape[1]}")
        return (f"{shape}, H={self.H}, Hk={self.Hk}, D={self.D}, {kind}, causal, "
                + ("no mask" if self.mask is None else f"mask {list(self.mask.shape)}")
                + f", dropout {self.rate}")


def _abi_check(torch, checks, case):
    """The case's outputs (host buffers) against the plain versions on the
    same inputs over head groups: out rows within two bf16 ulps of their
    largest, live LSE rows to 1e-3, rows with no live key out 0 and lse
    -1e30; dq, and dk and dv summed over each GQA group, as check_k9_k10
    holds them (dq rows of queries with fewer than two live keys to the
    noise floor).  Returns the worst share of a tolerance."""
    q, k, v, causal, masks, bias, drop = case.args()
    B, Sq, H, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    scale = D ** -0.5
    vl = case.lens is not None

    def host(x):
        t = case.tensor(x)
        return t[None] if vl else t
    out = host(case.out)
    lse = torch.from_numpy(case.lse).cuda()
    lse = lse[None] if vl else lse
    rout, rlse = fwd_plain((q, k, v, causal, scale, None, None, False, masks, None, None, bias,
                            drop))
    _, s_out = row_err(out, rout)
    live = rlse > -1e29
    lerr = float((lse - rlse).abs()[live].max())
    dead_ok = bool((lse[~live] == -1e30).all() and (out.transpose(1, 2)[~live] == 0).all())
    del rout, rlse
    dout = host(case.dout)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    rdq, rdk, rdv = bwd_plain((q, k, v, dout, lse, delta, causal, scale, None, None, None, None,
                               masks, bias, drop))
    counts = _live_keys(torch, masks, causal, Sq, Sk, bias, H)
    floor = torch.where(counts < 2, 2.0 ** -12 * float(rdq.abs().max()), 1e-6)
    G = H // Hk
    shares = [row_err(host(case.dq), rdq, floor=floor)[1]]
    for got, ref in ((case.dk, rdk), (case.dv, rdv)):
        ref = ref.reshape(B, Hk, G, Sk, D).sum(2).transpose(1, 2)
        shares.append(row_err(host(got), ref)[1])
    del rdq, rdk, rdv
    label = f"phase 18 {case.label()}"
    ok = checks.check(f"{label} out", s_out, 1.0) & checks.check(f"{label} lse", lerr, 1e-3)
    for name, sh in zip(("dq", "dk", "dv"), shares):
        ok = checks.check(f"{label} {name}", sh, 1.0) & ok
    if not dead_ok:
        checks.failed.append(f"{label}: a row with no live key is not out 0 / lse -1e30")
    say(f"  {label}: against the plain versions: out {s_out:.3f} of its row's tol, lse err "
        f"{lerr:.3e} (tol 1e-3), dead rows out 0 / lse -1e30 {dead_ok}; dq {shares[0]:.3f}, "
        f"dk {shares[1]:.3f}, dv {shares[2]:.3f} of their rows' tol "
        f"{'ok' if ok and dead_ok else 'FAIL'}")
    return max(s_out, *shares)


def _abi_kernel_ms(torch, case):
    """The kernels alone on the case's inputs on the card, as the executor
    calls them (CUDA events): (K4 ms, K9 + K10 ms)."""
    from flash_attn_tpu_torch.ops import flash_bwd as fb
    from flash_attn_tpu_torch.ops import flash_fwd as ff

    q, k, v, causal, masks, bias, drop = case.args()
    scale = q.shape[-1] ** -0.5
    fargs = (q, k, v, causal, scale, None, None, False, masks, None, None, bias, drop)
    out, lse = ff.flash_fwd_cuda(*fargs)
    dout = case.tensor(case.dout)
    dout = dout[None] if case.lens else dout
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    bargs = (q, k, v, dout, lse, delta, causal, scale, None, None, None, None, masks, bias, drop)
    return (cuda_ms(torch, lambda: ff.flash_fwd_cuda(*fargs), iters=10),
            cuda_ms(torch, lambda: fb.flash_bwd_cuda(*bargs), iters=10))


def phase_abi(torch, checks, smi):
    """Phase 18: the C entry points (runtime/abi.py, runtime/native/
    fatt_abi.cc) called through ctypes from host numpy buffers, the torch
    executor on the card: at Llama-3-8B's attention widths (H=32, Hk=8,
    D=128, bf16) varlen 8 sequences in 8192 tokens (ABI_LENS), causal,
    dropout 0.1, with a [8192, 8192] fp32 mask and without; dense B=2,
    S=2048, causal, a [2, 1, 2048, 2048] mask and dropout, in bf16 and in
    fp16; at GPT-2's (H=Hk=12, D=64) dense B=4, S=1024 likewise; each
    forward then backward, ABI_REPEATS calls each (the repeats bitwise
    equal).  An fp32 call must return false with a message naming fp32.
    The counters are set to 0 before the calls and read after them: every
    forward is one launch of K4's kExtra instance, every backward one of
    K9's and K10's kOpt instances.  Then, outside the count, the outputs
    against the plain versions over head groups, and each call's ms host
    to host beside the kernels' own time (CUDA events) and their share."""
    import numpy as np

    from flash_attn_tpu_torch.runtime import abi

    t0 = time.perf_counter()
    lib = abi.register_torch_executor()
    g = torch.Generator(device="cuda").manual_seed(SEED + 74)
    total = sum(ABI_LENS)
    cases = [
        _AbiCall(torch, g, abi, lens=ABI_LENS, mask=(total, total)),
        _AbiCall(torch, g, abi, lens=ABI_LENS),
        _AbiCall(torch, g, abi, B=2, S=2048, mask=(2, 1, 2048, 2048)),
        _AbiCall(torch, g, abi, B=2, S=2048, mask=(2, 1, 2048, 2048), code=2),
        _AbiCall(torch, g, abi, B=4, S=1024, H=12, Hk=12, D=64, mask=(4, 1, 1024, 1024)),
    ]
    f32 = _AbiCall(torch, g, abi, B=1, S=256, code=0)
    torch.cuda.synchronize()
    _reset_counts()
    secs = {}
    for i, case in enumerate(cases):
        for backward in (False, True):
            outs, times = [], []
            for _ in range(ABI_REPEATS):
                ok, sec = case.run(lib, backward)
                if not ok:
                    checks.failed.append(f"phase 18 {case.label()}: "
                                         f"{lib.fatt_last_error().decode()}")
                    break
                times.append(sec)
                bufs = (case.dq, case.dk, case.dv) if backward else (case.out, case.lse)
                outs.append([b.copy() for b in bufs])
            same = len(outs) == ABI_REPEATS and all(
                np.array_equal(a, b) for o in outs[1:] for a, b in zip(outs[0], o))
            if not same:
                checks.failed.append(f"phase 18 {case.label()}: repeated calls differ")
            secs[i, backward] = (times, same)
    refused, _ = f32.run(lib, False)
    msg = lib.fatt_last_error().decode()
    counts = _read_counts()
    if refused or "fp32" not in msg:
        checks.failed.append(f"phase 18: an fp32 call on the card gave {refused}, {msg!r}")
    n = len(cases) * ABI_REPEATS
    _launches_exact(checks, RUN_ABI, counts, {"K4": n, "K4 extra": n, "K4 dropout": n,
                                              "K9": n, "K9 opt": n, "K10": n, "K10 opt": n})
    say(f"[{RUN_ABI}] {smi} | the fp32 call refused: {not refused} ({msg!r}) | launches "
        + ", ".join(f"{key} {counts[key]}" for key in (
            "K4", "K4 extra", "K4 seg", "K4 dropout", "K9 opt", "K9 seg", "K10 opt",
            "K10 seg")))
    say("kernels " + json.dumps({"run": RUN_ABI, **counts}))
    worst = 0.0
    for i, case in enumerate(cases):
        worst = max(worst, _abi_check(torch, checks, case))
        k4_ms, bwd_ms = _abi_kernel_ms(torch, case)
        for backward, kernel_ms, kname in ((False, k4_ms, "K4"), (True, bwd_ms, "K9 + K10")):
            times, same = secs[i, backward]
            host_ms = 1e3 * float(np.median(times[1:] if len(times) > 1 else times))
            say(f"  phase 18 {case.label()}, {'backward' if backward else 'forward'}: "
                f"{host_ms:.3f} ms a call host to host (median of calls 2-{ABI_REPEATS}; "
                f"{', '.join(f'{1e3 * x:.3f}' for x in times)}), {kname} alone "
                f"{kernel_ms:.4f} ms, {kernel_ms / host_ms:.4f} of the call; repeats "
                f"bitwise equal {same}")
        torch.cuda.empty_cache()
    say(f"[{RUN_ABI}] worst share of a tolerance {worst:.3f} | {time.perf_counter() - t0:.2f}s")
    del cases, f32
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def phase_packed_train(torch, checks, smi):
    """Phase 19: packed-document training of Llama-3 at 8B widths and
    TRAIN_LAYERS layers, B=1, S=TRAIN_SEQ as phase 8, the row packing
    PACKED_DOCS (segment ids 1-4, RoPE positions restarting a document):
    K4's masked instance forward (twice a layer: remat reruns it), K9's
    and K10's kOpt instances with segment ids backward, once a layer.  The
    median step beside phase 8's."""
    from flash_attn_tpu_torch.models import llama

    t1 = time.perf_counter()
    cfg = dataclasses.replace(llama.LLAMA3_8B, num_layers=TRAIN_LAYERS)
    params, _ = _fresh_model(torch, cfg)
    n = TRAIN_LAYERS * TRAIN_STEPS
    want = {"K9": n, "K10": n, "K9 opt": n, "K10 opt": n, "K9 seg": n, "K10 seg": n,
            "K4": 2 * n, "K4 seg": 2 * n}
    counts = _train_run(torch, checks, smi, RUN_PACKED_TRAIN, params,
                        _packed_train_fwd(torch, cfg, PACKED_DOCS), cfg.vocab_size, TRAIN_SEQ,
                        SEED + 73, want, t1)
    live = sum(d * (d + 1) // 2 for d in PACKED_DOCS)
    full = TRAIN_SEQ * (TRAIN_SEQ + 1) // 2
    say(f"  phase 19 step {STEP_MS[RUN_PACKED_TRAIN]:.3f} ms beside phase 8's unpacked "
        f"{STEP_MS[RUN_TRAIN]:.3f} ms ({STEP_MS[RUN_PACKED_TRAIN] / STEP_MS[RUN_TRAIN]:.4f}); "
        f"attention's live pairs {live} of the causal {full} ({live / full:.4f})")
    return counts


GEMMA_TRAIN_LAYERS, GEMMA_TRAIN_SEQ = 8, 8192
GEMMA27_TRAIN_LAYERS = 4


def phase_gemma_train(torch, checks, smi, size="9B"):
    """Phase 11: Gemma-2 at 9B widths and GEMMA_TRAIN_LAYERS layers (half
    sliding, half global; bf16 params and moments from the seed: 2.504 B
    parameters, 20.0 GB with gradients and moments), B=1,
    S=GEMMA_TRAIN_SEQ (past the 4096 window); K9 and K10 launch once a
    layer a step, half of them windowed, all at head_dim 256 (kLocal), and
    K4 twice (remat reruns it).  Phase 15 (``size`` "27B"): Gemma-2 at 27B
    widths and GEMMA27_TRAIN_LAYERS layers (3.445 B parameters), the same
    counts on the head_dim 128 kLocal instances, and the median step
    beside its bound: the fp32 tied head's three products at
    F32_FLOPS_PER_S, the layers' bf16 GEMMs (the forward, the backward's
    two products, remat's rerun) and the attention products (K4's two a
    pass, twice; K9's three; K10's four, 2*D flops a live pair each) at
    BF16_FLOPS_PER_S, and AdamW's bytes (each bf16 param, gradient and two
    moments read once, the param and moments written once) at
    HBM_BYTES_PER_S."""
    from flash_attn_tpu_torch.models import gemma2
    from flash_attn_tpu_torch.ops.flash_fwd import live_pairs
    from flash_attn_tpu_torch.utils import train

    t1 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    big = size == "27B"
    base, layers, run = ((gemma2.GEMMA2_27B, GEMMA27_TRAIN_LAYERS, RUN_GEMMA27_TRAIN) if big
                         else (gemma2.GEMMA2_9B, GEMMA_TRAIN_LAYERS, RUN_GEMMA_TRAIN))
    cfg = dataclasses.replace(base, num_layers=layers)
    params = gemma2.init_params(cfg, seed=SEED, device="cuda")
    fwd = lambda p, tokens, remat: gemma2.forward(p, tokens, cfg, remat=remat)  # noqa: E731
    n = layers * TRAIN_STEPS
    d256 = n * (cfg.head_dim == 256)
    want = {"K9": n, "K9 local": n, "K9 d256": d256, "K9 window": n // 2, "K10": n,
            "K10 local": n, "K10 d256": d256, "K10 window": n // 2, "K4": 2 * n,
            "K4 local": 2 * n, "K4 d256": 2 * d256, "K4 window": n}
    bound_ms = None
    if big:
        S, h, V = GEMMA_TRAIN_SEQ, cfg.hidden, cfg.vocab_size
        qd, kvd = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
        dense = 2 * (2 * h * qd + 2 * h * kvd + 3 * h * cfg.intermediate)  # a token, a layer
        head = 3 * 2 * S * h * V
        gemms = 4 * layers * S * dense
        pairs = sum(int(live_pairs(None, True, S, S, "cuda",
                                   gemma2._wnd(cfg, i)).sum()) for i in range(layers))
        attn = 11 * 2 * cfg.head_dim * cfg.num_heads * pairs
        n_params = sum(p.numel() for p in train.param_leaves(params))
        adam = 7 * 2 * n_params
        parts = (head / F32_FLOPS_PER_S, (gemms + attn) / BF16_FLOPS_PER_S,
                 adam / HBM_BYTES_PER_S)
        bound_ms = 1e3 * sum(parts)
        say(f"  phase 15 bound: the fp32 head {head / 1e12:.3f} TFLOP ({1e3 * parts[0]:.3f} ms "
            f"at {F32_FLOPS_PER_S / 1e12:g} TFLOP/s), bf16 GEMMs {gemms / 1e12:.3f} TFLOP and "
            f"attention {attn / 1e12:.3f} TFLOP on {pairs} live pairs a head "
            f"({1e3 * parts[1]:.3f} ms at {BF16_FLOPS_PER_S / 1e12:g} TFLOP/s), AdamW "
            f"{adam / 1e9:.3f} GB ({1e3 * parts[2]:.3f} ms at {HBM_BYTES_PER_S / 1e12:g} TB/s)")
    return _train_run(torch, checks, smi, run, params, fwd, cfg.vocab_size, GEMMA_TRAIN_SEQ,
                      SEED + (20 if big else 16), want, t1, bound_ms=bound_ms)


GPT2_TOKENS = 64             # greedy tokens a request in phase 12
GPT2_BASELINE_PROMPT = 960   # BASELINE config 0: the prompt and its 64 tokens fill 1024


def _same_tokens(run, want):
    """(tokens equal, of all; each request's first divergence or None)."""
    same = sum(a == b for r, w in zip(run["tokens"], want["tokens"]) for a, b in zip(r, w))
    first = [next((i for i, (a, b) in enumerate(zip(r, w)) if a != b), None)
             for r, w in zip(run["tokens"], want["tokens"])]
    return same, sum(len(r) for r in want["tokens"]), first


def phase_gpt2(torch, checks, smi):
    """Phase 12: GPT-2 124M (BASELINE config 0's model: 12 layers, 12
    heads of 64, hidden 768, vocab 50257, 1024 positions), bf16 weights
    from the seed, max_batch 8, capacity 1024, 8 greedy prompts of 64-512
    tokens from the seed (_gpt2_prompts), GPT2_TOKENS tokens each, one
    prompt a prefill call (the prompts' total passes the capacity, so the
    engine packs none): int8 KV eager (``disable_graphs()``), captured
    (with a profiled window) and captured at decode_burst 4; fp8 KV eager
    and captured; int8 KV with prefill_chunk_size 256, packed (capacity
    4096, so the prompts fit one packed call), through
    PagedInferenceEngine (pages of 128), and with n-gram speculation
    (num_draft 4).  Eager, captured and burst 4 run the same kernels on
    the same shapes, so their tokens must be equal (and fp8's two); the
    paged and speculative runs share the captured run's prefill, so their
    first tokens must equal its; the chunked and packed runs change the
    prefill's arithmetic, and the paged and speculative decode run other
    kernels (K8, K1c), whose sums in another order flip near-tied greedy
    choices of random weights: their agreement with the captured run is
    printed, with each request's first divergence.  The launches must show
    the head_dim 64 kernels on every path: K4 12 a prefill call, K1, K2
    and K1m 12 a decode step, K1c 12 a verify round, K8 12 a paged step.
    Then BASELINE config 0 itself: batch 1, int8 KV, a
    GPT2_BASELINE_PROMPT-token prompt whose GPT2_TOKENS tokens take the
    sequence to 1024 positions, captured.  Returns {run label: counts}."""
    import numpy as np

    from flash_attn_tpu_torch.engine._graph import disable_graphs
    from flash_attn_tpu_torch.engine.engine import SpecConfig
    from flash_attn_tpu_torch.models import gpt2
    from flash_attn_tpu_torch.utils import train

    cfg = _gpt2_cfg()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = gpt2.init_params(cfg, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in train.param_leaves(params))
    say(f"  GPT-2 124M params (bf16, {n_params} parameters, the tied head fp32 at first use) "
        f"on the card in {time.perf_counter() - t0:.2f}s, "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    prompts = _gpt2_prompts(cfg.vocab_size)
    L, n_tok = cfg.num_layers, GPT2_TOKENS
    base = ("K1", "K1m", "K2", "K4", "K4 d64", "K1 d64")
    kw = dict(adapter=gpt2.make_adapter(cfg), capacity=cfg.max_position, prompts=prompts,
              packed=False)
    with disable_graphs():
        eager = serve(torch, checks, f"{RUN_GPT2}, eager", cfg, params, "int8", n_tok, base, **kw)
    graph = serve(torch, checks, RUN_GPT2, cfg, params, "int8", n_tok, base, window=True, **kw)
    burst = serve(torch, checks, f"{RUN_GPT2}, burst 4", cfg, params, "int8", n_tok, base,
                  burst=4, **kw)
    with disable_graphs():
        f8e = serve(torch, checks, f"{RUN_GPT2_FP8}, eager", cfg, params, "fp8", n_tok, base,
                    **kw)
    f8 = serve(torch, checks, RUN_GPT2_FP8, cfg, params, "fp8", n_tok, base, **kw)
    chunked = serve(torch, checks, RUN_GPT2_CHUNK, cfg, params, "int8", n_tok, base, chunk=256,
                    **kw)
    packed = serve(torch, checks, RUN_GPT2_PACKED, cfg, params, "int8", n_tok, base,
                   **dict(kw, capacity=4096, packed=True))
    paged = serve(torch, checks, RUN_GPT2_PAGED, cfg, params, "int8", n_tok,
                  ("K4", "K8", "K8 d64"), paged=True, **kw)
    spec = serve(torch, checks, RUN_GPT2_SPEC, cfg, params, "int8", n_tok,
                 ("K1c", "K1m", "K4", "K1 d64"), spec=SpecConfig(num_draft=4, ngram=2), **kw)
    for name, run, want in (("eager", eager, graph), ("burst 4", burst, graph),
                            ("fp8 eager", f8e, f8)):
        if run["tokens"] != want["tokens"]:
            checks.failed.append(f"{RUN_GPT2}: {name} tokens differ from the captured run's")
    for name, run in (("paged", paged), ("n-gram", spec)):
        if [r[:1] for r in run["tokens"]] != [r[:1] for r in graph["tokens"]]:
            checks.failed.append(f"{RUN_GPT2}: the {name} run's first tokens (the same "
                                 "prefill) differ from the captured run's")
    # the launches: every path at head_dim 64
    n_req = len(prompts[1])
    n_chunks = sum(-(-len(p) // 256) if len(p) > 256 else 1 for p in prompts[1])
    expect = []
    for name, run in (("eager", eager), ("captured", graph), ("fp8 eager", f8e), ("fp8", f8)):
        steps = run["dispatches"]
        expect.append((name, run, {"K4": L * n_req, "K4 d64": L * n_req, "K1": L * steps,
                                   "K1 d64": L * steps, "K2": L * steps, "K1m": L * steps}))
    expect.append(("prefill_chunk_size 256", chunked, {"K4": L * n_chunks,
                                                       "K4 d64": L * n_chunks}))
    expect.append(("packed", packed, {"K4": L, "K4 seg": L, "K4 d64": L}))
    expect.append(("paged", paged, {"K4": L * n_req, "K8": L * paged["dispatches"],
                                    "K8 d64": L * paged["dispatches"], "K1": 0}))
    expect.append(("n-gram", spec, {"K1c": L * spec["rounds"],
                                    "K1 d64": spec["counts"]["K1"] + L * spec["rounds"]}))
    for name, run, want in expect:
        got = {key: run["counts"][key] for key in want}
        if got != want:
            checks.failed.append(f"{RUN_GPT2}, {name}: launches {got}, expected {want}")
    parts = []
    for name, run in (("prefill_chunk_size 256", chunked), ("packed", packed),
                      ("paged", paged), ("n-gram", spec)):
        same, total, first = _same_tokens(run, graph)
        parts.append(f"{name} {same}/{total} (first divergence {first})")
    c, dev = graph["counts"], graph["dev_ms"]
    say(f"[{RUN_GPT2}: eager / captured / burst 4 / fp8] {smi} | decode eager "
        f"{eager['pos_ms']:.3f} ms a position ({eager['tok_s']:.1f} tok/s), captured "
        f"{graph['pos_ms']:.3f} ms ({graph['tok_s']:.1f} tok/s), the card {dev:.3f} ms a position "
        f"(graph replays; idle share unprofiled {1 - dev / graph['pos_ms']:.4f}), burst 4 "
        f"{burst['pos_ms']:.3f} ms ({burst['tok_s']:.1f} tok/s, the card {burst['dev_ms']:.3f}), "
        f"fp8 captured {f8['pos_ms']:.3f} ms ({f8['tok_s']:.1f} tok/s, the card "
        f"{f8['dev_ms']:.3f}) | prefill {graph['prefill_tok_s']:.1f} tok/s (one prompt a call), "
        f"chunks of 256 {chunked['prefill_tok_s']:.1f}, packed {packed['prefill_tok_s']:.1f} | "
        f"paged {paged['pos_ms']:.3f} ms a position ({paged['tok_s']:.1f} tok/s), n-gram "
        f"{spec['pos_ms']:.3f} ms a verify round ({spec['rounds']} rounds) | peak "
        f"{graph['peak']:.3f} GiB | launches (captured): K4 {c['K4']} = {L} x {n_req} prefill "
        f"calls, K1 {c['K1']} = K2 {c['K2']} = K1m {c['K1m']} = {L} x {graph['dispatches']} "
        f"steps, all at head_dim 64 (K4 d64 {c['K4 d64']}, K1 d64 {c['K1 d64']}); K1c "
        f"{spec['counts']['K1c']} = {L} x {spec['rounds']} verify rounds; K8 "
        f"{paged['counts']['K8']} = {L} x {paged['dispatches']} paged steps | tokens equal to "
        f"the captured run: eager {eager['tokens'] == graph['tokens']}, burst 4 "
        f"{burst['tokens'] == graph['tokens']}, fp8 eager / captured "
        f"{f8e['tokens'] == f8['tokens']}; " + "; ".join(parts))
    wall, busy, top = graph["window"]
    say(f"  captured window of {WINDOW_STEPS} steps ({smi}), torch.profiler: wall {wall:.3f} ms, "
        f"card busy {busy:.3f} ms, idle share {1 - busy / wall:.4f}; top 5: "
        + ", ".join(f"{n[:60]} {ms:.3f} ms x{cnt}" for n, ms, cnt in top))
    # BASELINE config 0: batch 1, int8 KV, 1024 positions
    rng = np.random.default_rng(SEED + 56)
    one = (np.array([GPT2_BASELINE_PROMPT]),
           [rng.integers(0, cfg.vocab_size, GPT2_BASELINE_PROMPT).tolist()])
    with disable_graphs():
        b_eager = serve(torch, checks, f"{RUN_GPT2_BASE}, eager", cfg, params, "int8", n_tok,
                        base, max_batch=1, **dict(kw, prompts=one))
    b = serve(torch, checks, RUN_GPT2_BASE, cfg, params, "int8", n_tok, base, max_batch=1,
              **dict(kw, prompts=one))
    if b["tokens"] != b_eager["tokens"]:
        checks.failed.append(f"{RUN_GPT2_BASE}: eager tokens differ from the captured run's")
    want = {"K4": L, "K1": L * b["dispatches"], "K2": L * b["dispatches"],
            "K1m": L * b["dispatches"]}
    got = {key: b["counts"][key] for key in want}
    if got != want:
        checks.failed.append(f"{RUN_GPT2_BASE}: launches {got}, expected {want}")
    say(f"[{RUN_GPT2_BASE}] {smi} | decode captured {b['pos_ms']:.3f} ms a position "
        f"({b['tok_s']:.1f} tok/s), eager {b_eager['pos_ms']:.3f} ms, the card "
        f"{b['dev_ms']:.3f} ms a position (graph replays; idle share unprofiled "
        f"{1 - b['dev_ms'] / b['pos_ms']:.4f}) | prefill {b['prefill_tok_s']:.1f} tok/s (the "
        f"1024 bucket) | {GPT2_BASELINE_PROMPT} + {n_tok} = 1024 positions | peak "
        f"{b['peak']:.3f} GiB | launches {got} | tokens equal eager / captured "
        f"{b['tokens'] == b_eager['tokens']}")
    gpt2_ppl(torch, checks, smi, cfg, params, one[1][0],
             rng.integers(0, cfg.vocab_size, GPT2_TOKENS))
    runs = {label: run["counts"] for label, run in (
        (RUN_GPT2, graph), (RUN_GPT2_FP8, f8), (RUN_GPT2_CHUNK, chunked),
        (RUN_GPT2_PACKED, packed), (RUN_GPT2_PAGED, paged), (RUN_GPT2_SPEC, spec),
        (RUN_GPT2_BASE, b))}
    del params
    _free(torch)
    return runs


PPL_BOUND = 0.05  # |delta ppl| / ppl of the float cache (tests/test_hf_parity.py:88-103)


def gpt2_ppl(torch, checks, smi, cfg, params, prompt, continuation):
    """The perplexity line, BASELINE's "perplexity delta at same KV bit
    width": utils/ppl.kv_ppl_delta on phase 12's GPT-2 124M params, the
    BASELINE prompt (GPT2_BASELINE_PROMPT tokens) and a continuation of
    GPT2_TOKENS tokens from the seed, teacher-forced through prefill (K4)
    and decode steps (K1, K2, K1m) with the cache in bf16, int8 and fp8.
    Fails unless every value is finite and each quantized cache's |delta|
    is under PPL_BOUND of the bf16 cache's perplexity."""
    import math

    from flash_attn_tpu_torch.utils import ppl

    t0 = time.perf_counter()
    res = ppl.kv_ppl_delta(params, cfg, prompt, continuation, modes=("int8", "fp8"))
    base = res["none"]["ppl"]
    ok = all(math.isfinite(v) for r in res.values() for v in r.values())
    if not ok:
        checks.failed.append(f"phase 12 perplexity: a value is not finite: {res}")
    for mode in ("int8", "fp8"):
        ok = checks.check(f"phase 12 perplexity delta {mode} (relative)",
                          abs(res[mode]["delta_ppl"]) / base, PPL_BOUND) and ok
    say(f"[phase 12 perplexity, GPT-2 124M bf16, a {len(prompt)}-token prompt and "
        f"{len(continuation)} tokens teacher-forced] {smi} | " + "; ".join(
            f"{mode} KV nll {r['nll']:.6f} ppl {r['ppl']:.3f} delta {r['delta_ppl']:+.4f} "
            f"({abs(r['delta_ppl']) / base:.2e} of the bf16 cache's, bound {PPL_BOUND})"
            for mode, r in (("bf16", res["none"]), ("int8", res["int8"]), ("fp8", res["fp8"])))
        + f" {'ok' if ok else 'FAIL'} | {time.perf_counter() - t0:.2f}s")


GPT2_TRAIN_BATCH = 8  # phase 13: B=8 sequences of GPT-2's 1024-token context


def phase_gpt2_train(torch, checks, smi):
    """Phase 13: GPT-2 124M at full depth (12 layers, 12 heads of 64,
    bf16 params and AdamW moments from the seed), B=GPT2_TRAIN_BATCH,
    S=1024 (its context), TRAIN_STEPS AdamW steps through _train_run; K9
    and K10 launch once a layer a step, K4 twice (remat reruns it), all at
    head_dim 64.  The step's bound: its fp32 products (each layer's four
    dense layers and the tied head: the forward, the backward's two
    products a product, and remat's rerun of the blocks) at
    F32_FLOPS_PER_S, as JAX computes them in fp32, plus the attention
    products (K4's two a pass, twice; K9's three; K10's four, 2*D flops a
    live pair each) at BF16_FLOPS_PER_S."""
    from flash_attn_tpu_torch.models import gpt2

    t1 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = _gpt2_cfg()
    params = gpt2.init_params(cfg, seed=SEED + 18, device="cuda")
    fwd = lambda p, tokens, remat: gpt2.forward(p, tokens, cfg, remat=remat)  # noqa: E731
    L, h, V, S, B = cfg.num_layers, cfg.hidden, cfg.vocab_size, cfg.max_position, GPT2_TRAIN_BATCH
    dense = 2 * h * (3 * h + h + 4 * h + 4 * h)  # a token's flops in one layer's dense layers
    f32 = B * S * (3 * (L * dense + 2 * h * V) + L * dense)
    attn = 11 * 2 * cfg.head_dim * B * cfg.num_heads * L * (S * (S + 1) // 2)
    bound_ms = (f32 / F32_FLOPS_PER_S + attn / BF16_FLOPS_PER_S) * 1e3
    say(f"  phase 13 bound: fp32 products {f32 / 1e12:.3f} TFLOP a step "
        f"({f32 / F32_FLOPS_PER_S * 1e3:.3f} ms at {F32_FLOPS_PER_S / 1e12:g} TFLOP/s), attention "
        f"{attn / 1e12:.3f} TFLOP ({attn / BF16_FLOPS_PER_S * 1e3:.3f} ms at "
        f"{BF16_FLOPS_PER_S / 1e12:g} TFLOP/s)")
    n = L * TRAIN_STEPS
    want = {"K9": n, "K9 d64": n, "K10": n, "K10 d64": n, "K4": 2 * n, "K4 d64": 2 * n}
    return _train_run(torch, checks, smi, RUN_GPT2_TRAIN, params, fwd, V, S, SEED + 19, want,
                      t1, batch=B, bound_ms=bound_ms)


SP_N, SP_S = 4, 16384  # phase 20: ranks, and tokens over them (S_loc 4096)
SP_WINDOW = (4095, -1)  # phase 20's windowed ring: Mistral-7B's window


def _rel_norm(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm().clamp(min=1e-30))


def _sp_run(torch, checks, label, fn, args, ref, want, dout=None):
    """One call of ``fn(*args)`` (forward, and backward with ``dout``)
    with every launch count zeroed just before and read just after, held
    to ``want`` exactly; its output against ``ref``'s (each row to two bf16
    ulps of its largest) and, with ``dout``, each gradient to TRAIN_GRAD_TOL
    of its norm (phase 3's rule).  Then ms a call (CUDA events, 3 calls).
    Returns (counts, output, gradients)."""
    _reset_counts()
    out = fn(*args)
    grads = torch.autograd.grad(out, args, dout) if dout is not None else ()
    torch.cuda.synchronize()
    counts = _read_counts()
    _launches_exact(checks, label, counts, want)
    ref_out, ref_grads = ref
    err, share = row_err(out.detach(), ref_out)
    ok = checks.check(f"{label} out", share, 1.0)
    gerrs = [_rel_norm(g, r) for g, r in zip(grads, ref_grads)]
    for name, e in zip(("q", "k", "v", "bias"), gerrs):
        ok = checks.check(f"{label} d{name} (relative norm)", e, TRAIN_GRAD_TOL) and ok

    def call():
        o = fn(*args)
        if dout is not None:
            torch.autograd.grad(o, args, dout)

    ms = cuda_ms(torch, call, iters=3, warmup=1)
    say(f"  {label}: out max_abs_err {err:.3e} ({share:.3f} of its row's tol)"
        + (f", {' '.join('d' + n for n in ('q', 'k', 'v', 'bias')[:len(gerrs)])} relative "
           f"norm err {', '.join(f'{e:.3e}' for e in gerrs)} (tol "
           f"{TRAIN_GRAD_TOL:g})" if gerrs else "")
        + f" {'ok' if ok else 'FAIL'} | launches {({k: counts[k] for k in want})} | "
        f"{ms:.3f} ms a call")
    return counts, out.detach(), grads


def phase_sp(torch, checks, smi):
    """Phase 20: sequence-parallel attention at Llama-3-8B's attention
    widths (H=32, Hk=8, D=128, bf16), B=1, SP_S tokens over SP_N ranks that
    share cuda:0 (make_mesh with the card given SP_N times): the ring over
    K4 / K9 + K10, contiguous and striped, causal, forward and backward
    through autograd; the one-kernel ring (K11) forward; Ulysses forward and
    backward.  Each is held to the single-device flash_attention on the
    whole sequence (K4, K9 + K10), with its launches a call exact: the
    contiguous ring K4 = K9 = K10 = 10 (ranks 0-3 live on 1-4 steps), the
    striped 16, K11 1, Ulysses 4 (one a rank).  The contiguous ring with
    Mistral-7B's window SP_WINDOW (the positions path: each step passes
    the shards' global positions, K4's masked kLocal instance forward, K9's
    and K10's kLocal and kOpt instances backward, 10 each) is held to one
    windowed flash_attention over the whole sequence (K4's and K9/K10's
    kLocal instances without masks)."""
    from flash_attn_tpu_torch.ops.attention import flash_attention
    from flash_attn_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from flash_attn_tpu_torch.parallel.rdma_ring import make_rdma_ring_attention
    from flash_attn_tpu_torch.parallel.ring import (
        make_ring_attention,
        stripe_sequence,
        unstripe_sequence,
    )
    from flash_attn_tpu_torch.parallel.ulysses import make_ulysses_attention

    t0 = time.perf_counter()
    n, S, H, Hk, D = SP_N, SP_S, K11_H, K11_HK, K11_D
    say(f"[phase 20 sequence-parallel attention] B=1 S={S} H={H} Hk={Hk} D={D} bf16, causal, "
        f"{n} ranks sharing one card ({smi}): each rotation or push is a device-local copy, so "
        "these times say nothing about NVLink")
    mesh = make_mesh(MeshConfig(sp=n), devices=["cuda:0"] * n)
    g = torch.Generator(device="cuda").manual_seed(SEED + 81)

    def rnd(h):
        return torch.randn((1, S, h, D), generator=g, device="cuda").to(torch.bfloat16)

    q, k, v, dout = rnd(H), rnd(Hk), rnd(Hk), rnd(H)
    q.requires_grad_(True)
    k.requires_grad_(True)
    v.requires_grad_(True)
    single = lambda q_, k_, v_: flash_attention(q_, k_, v_, causal=True)  # noqa: E731
    ref_out = single(q, k, v)
    ref = (ref_out.detach(), torch.autograd.grad(ref_out, (q, k, v), dout))
    del ref_out
    ms1 = cuda_ms(torch, lambda: torch.autograd.grad(single(q, k, v), (q, k, v), dout),
                  iters=3, warmup=1)
    say(f"  single-device flash_attention (K4, K9 + K10) on the whole sequence: {ms1:.3f} ms "
        "a forward + backward call")
    runs = {}
    ring = make_ring_attention(mesh, causal=True)
    want = {"K4": 10, "K9": 10, "K10": 10}
    runs[RUN_SP_RING], ring_out, _ = _sp_run(torch, checks, "ring contiguous", ring,
                                             (q, k, v), ref, want, dout)
    # the windowed ring (positions path) against one windowed call
    wsingle = lambda q_, k_, v_: flash_attention(q_, k_, v_, causal=True,  # noqa: E731
                                                 window=SP_WINDOW)
    wref_out = wsingle(q, k, v)
    wref = (wref_out.detach(), torch.autograd.grad(wref_out, (q, k, v), dout))
    del wref_out
    msw = cuda_ms(torch, lambda: torch.autograd.grad(wsingle(q, k, v), (q, k, v), dout),
                  iters=3, warmup=1)
    say(f"  single-device flash_attention with the window {SP_WINDOW} (K4, K9 + K10 kLocal) on "
        f"the whole sequence: {msw:.3f} ms a forward + backward call")
    want = {"K4": 10, "K9": 10, "K10": 10, "K4 local seg": 10, "K4 pos": 10, "K4 seg": 0,
            "K9 local": 10, "K10 local": 10, "K9 opt": 10, "K10 opt": 10}
    runs[RUN_SP_WINDOW], _, _ = _sp_run(torch, checks, f"ring contiguous, window {SP_WINDOW}",
                                        make_ring_attention(mesh, causal=True, window=SP_WINDOW),
                                        (q, k, v), wref, want, dout)
    del wref
    striped = make_ring_attention(mesh, causal=True, layout="striped")

    def striped_call(q_, k_, v_):
        return unstripe_sequence(striped(*(stripe_sequence(x, n) for x in (q_, k_, v_))), n)

    want = {"K4": 16, "K9": 16, "K10": 16}
    runs[RUN_SP_STRIPED], _, _ = _sp_run(torch, checks, "ring striped", striped_call,
                                         (q, k, v), ref, want, dout)
    rdma = make_rdma_ring_attention(mesh, causal=True)
    with torch.no_grad():
        runs[RUN_SP_RDMA], rdma_out, _ = _sp_run(
            torch, checks, "rdma ring (K11) vs the single call", rdma,
            (q.detach(), k.detach(), v.detach()), (ref[0], ()), {"K11": 1, "K4": 0})
    err, share = row_err(rdma_out, ring_out)
    checks.check("rdma ring vs ring out", share, 1.0)
    say(f"  rdma ring (K11) vs make_ring_attention (K4): max_abs_err {err:.3e} ({share:.3f} of "
        f"its row's tol) {'ok' if share <= 1.0 else 'FAIL'}")
    uly = make_ulysses_attention(mesh, causal=True)
    want = {"K4": n, "K9": n, "K10": n}
    runs[RUN_SP_ULYSSES], uly_out, uly_grads = _sp_run(torch, checks, "Ulysses", uly, (q, k, v),
                                                       ref, want, dout)
    same = torch.equal(uly_out, ref[0]) and all(
        torch.equal(a, b) for a, b in zip(uly_grads, ref[1]))
    say(f"  Ulysses bitwise the single-device call (out, dq, dk, dv): {same}")
    del q, k, v, dout, ref, ring_out, rdma_out, uly_out, uly_grads
    gc.collect()
    torch.cuda.empty_cache()
    say(f"[phase 20 sequence-parallel attention] {time.perf_counter() - t0:.2f}s")
    return runs


LORA_TOKENS = 32


def _lora_launches(checks, label, run, L, prompts):
    """Phase 21's counts, exact: one prompt a prefill call (K4 L a call,
    no packed call), K1 = K2 = K1m = L a decode step, K3 4 a layer (wqkv,
    wo, w_gate_up, w_down) a prefill call or step; the head is float."""
    steps = run["dispatches"]
    return _launches_exact(checks, label, run["counts"], {
        "K4": L * prompts, "K4 seg": 0, "K1": L * steps, "K2": L * steps, "K1m": L * steps,
        "K3": 4 * L * (prompts + steps)})


def lora_http(torch, checks, cfg, params, bank, adapters, mixed):
    """Phase 21 (e): the same 8 requests over HTTP (serving.serve on port 0,
    a fresh engine with the bank, its LoRA decode step captured on the
    worker thread): 8 client threads POST /generate at once, their tokens
    equal to the mixed run's; a /stream client (request 1 anew) receives
    the same tokens in more than one line; one /generate alone (request 0)
    timed beside the engine's own seconds for it; /health reports the
    engine's metrics; a /submit followed by /cancel frees its slot; the
    server and worker shut down.  Returns the numbers to print."""
    import threading
    import urllib.request

    from flash_attn_tpu_torch.engine.engine import InferenceEngine
    from flash_attn_tpu_torch.models import llama
    from flash_attn_tpu_torch.serving import ServingConfig
    from flash_attn_tpu_torch.serving import serve as http_serve

    _, prompts = _prompts(cfg.vocab_size)
    eng = InferenceEngine(params, llama.make_adapter(cfg), max_batch=8, capacity=4096,
                          kv_mode="fp8", device="cuda", lora_bank=bank)
    srv, worker = http_serve(eng, ServingConfig(port=0), block=False)
    url = f"http://127.0.0.1:{srv.server_address[1]}"

    def post(path, body):
        req = urllib.request.Request(url + path, data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.loads(r.read())

    def get(path):
        with urllib.request.urlopen(url + path, timeout=120) as r:
            return json.loads(r.read())

    def body(i, max_tokens=LORA_TOKENS):
        return {"prompt": prompts[i], "max_tokens": max_tokens, "adapter": adapters[i]}

    out = {}
    try:
        results = [None] * len(prompts)

        def client(i):
            results[i] = post("/generate", body(i))["tokens"]

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        out["batch_s"] = time.perf_counter() - t0
        out["generate"] = [i for i, r in enumerate(results) if r != mixed["tokens"][i]]
        uid = post("/submit", body(1))["uid"]
        with urllib.request.urlopen(f"{url}/stream?uid={uid}", timeout=120) as r:
            lines = [json.loads(raw) for raw in r]
        out["lines"] = len(lines)
        out["stream"] = (bool(lines) and lines[-1]["done"] and len(lines) > 1
                         and [t for ln in lines for t in ln["tokens"]] == mixed["tokens"][1])
        m = eng.metrics
        before = m.prefill_seconds + m.decode_seconds
        t0 = time.perf_counter()
        one = post("/generate", body(0))["tokens"]
        out["one_s"] = time.perf_counter() - t0
        out["engine_s"] = m.prefill_seconds + m.decode_seconds - before
        out["one"] = one == mixed["tokens"][0]
        health = get("/health")
        out["health"] = health["ok"] and health["metrics"]["completed_requests"] >= 10
        uid = post("/submit", body(2, max_tokens=1024))["uid"]
        deadline = time.perf_counter() + 60
        while not get(f"/result?uid={uid}")["tokens"] and time.perf_counter() < deadline:
            time.sleep(0.005)
        cancelled = post("/cancel", {"uid": uid})["cancelled"]
        while (eng.sched.active or eng.sched.waiting) and time.perf_counter() < deadline:
            time.sleep(0.005)
        res = get(f"/result?uid={uid}")
        out["cancel"] = (cancelled and res["done"] and len(res["tokens"]) < 1024
                         and sorted(eng.sched.free_slots) == list(range(8)))
        out["calls"] = eng._decode_lora_jit.calls
        out["captured"] = eng._decode_lora_jit.graph is not None
    finally:
        srv.shutdown()
        srv.server_close()
        worker.stop_flag.set()
        worker.join(timeout=60)
    out["stopped"] = not worker.is_alive() and worker.error is None
    for key in ("stream", "one", "health", "cancel", "captured", "stopped"):
        if not out[key]:
            checks.failed.append(f"{RUN_LORA} over HTTP: {key} failed ({worker.error!r})")
    if out["generate"]:
        checks.failed.append(f"{RUN_LORA} over HTTP: /generate tokens differ from the direct "
                             f"run's in requests {out['generate']}")
    del eng, worker, srv
    _free(torch)
    return out


def phase_lora(torch, checks, smi):
    """Phase 21: multi-adapter LoRA serving.  LLAMA3_8B, int8 fused, fp8
    KV, capacity 4096, max_batch 8, phase 4's 8 prompts, LORA_TOKENS
    tokens each, with a bank of LORA_ADAPTERS rank-16 adapters
    (``lora_bank``: adapter 0 B = 0, 1-3 at LORA_SHARE), request i on
    adapter i % 4, every prompt prefilled alone (a bank never packs).
    Runs: the base model without a bank eager and captured, the bank
    eager and captured (the mixed run), the bank with every request on
    adapter 1, and the HTTP front end (``lora_http``).  Checks: (a) adapter
    0's requests equal the base run's tokens; (b) each of adapters 1-3
    changes a token of its requests; (c) requests 1 and 5 of the
    all-adapter-1 run equal the mixed run's; (d) eager equals captured;
    (e) lora_http's; every run's launches exact (``_lora_launches``).
    Prints decode ms a position and tokens/s, eager and captured, with the
    bank beside the base; prefill tokens/s; the bank's bytes; peak memory;
    the LoRA decode body's calls; a /generate's wall time beside the
    engine's.  Returns {run label: counts}."""
    from flash_attn_tpu_torch.engine._graph import disable_graphs
    from flash_attn_tpu_torch.models import llama, lora

    t0 = time.perf_counter()
    cfg = llama.LLAMA3_8B
    L = cfg.num_layers
    params, secs = _fresh_model(torch, cfg, quantize="int8")
    bank, shares = lora_bank(torch, params, SEED + 21)
    params = llama.fuse_projections(params)  # init_lora reads the unfused names
    _free(torch)
    bank_mib = sum(t.numel() * t.element_size() for t in lora.lora_tensors(bank)) / 2**20
    say(f"  8B params (int8 fused, bf16 embeddings and head) and a bank of {LORA_ADAPTERS} "
        f"rank-{LORA_RANK} adapters (alpha {LORA_ALPHA:g}) on the seven linear layers, fp32, "
        f"{bank_mib:.1f} MiB (the engine's bf16 copy {bank_mib / 2:.1f} MiB), on the card in "
        f"{time.perf_counter() - t0:.2f}s | adapter 1's delta rms / base rms at layer 0: "
        + ", ".join(f"{n} {v:.4f}" for n, v in shares.items()))
    path = ("K1", "K1m", "K2", "K3", "K4")
    n = len(_prompts(cfg.vocab_size)[1])
    adapters = [i % LORA_ADAPTERS for i in range(n)]
    kw = dict(cfg=cfg, params=params, kv_mode="fp8", max_tokens=LORA_TOKENS, path=path)
    with disable_graphs():
        base_eager = serve(torch, checks, f"{RUN_LORA_BASE}, eager", packed=False, **kw)
        eager = serve(torch, checks, f"{RUN_LORA}, eager", bank=bank, adapters=adapters, **kw)
    base = serve(torch, checks, RUN_LORA_BASE, packed=False, **kw)
    mixed = serve(torch, checks, RUN_LORA, bank=bank, adapters=adapters, **kw)
    ones = serve(torch, checks, RUN_LORA_ONES, bank=bank, adapters=[1] * n, **kw)
    for label, run in ((RUN_LORA_BASE, base), (f"{RUN_LORA_BASE}, eager", base_eager),
                       (RUN_LORA, mixed), (f"{RUN_LORA}, eager", eager), (RUN_LORA_ONES, ones)):
        _lora_launches(checks, label, run, L, n)
    tok, want = mixed["tokens"], base["tokens"]
    verdict = {
        "(a) adapter 0 = base": all(tok[i] == want[i] for i in range(n) if adapters[i] == 0),
        "(b) adapters 1-3 change tokens": all(
            any(tok[i] != want[i] for i in range(n) if adapters[i] == a)
            for a in range(1, LORA_ADAPTERS)),
        "(c) all on adapter 1 = mixed at 1, 5": all(ones["tokens"][i] == tok[i]
                                                  for i in range(n) if adapters[i] == 1),
        "(d) eager = captured": eager["tokens"] == tok and base_eager["tokens"] == want,
    }
    for name, ok in verdict.items():
        if not ok:
            checks.failed.append(f"{RUN_LORA}: check {name} failed")
    changed = [sum(a != b for a, b in zip(tok[i], want[i])) for i in range(n)]
    http = lora_http(torch, checks, cfg, params, bank, adapters, mixed)
    peak = torch.cuda.max_memory_allocated() / 2**30
    say(f"[{RUN_LORA}: base / bank] {smi} | decode eager {base_eager['pos_ms']:.3f} / "
        f"{eager['pos_ms']:.3f} ms a position ({base_eager['tok_s']:.1f} / {eager['tok_s']:.1f} "
        f"tok/s), captured {base['pos_ms']:.3f} / {mixed['pos_ms']:.3f} ms a position "
        f"({base['tok_s']:.1f} / {mixed['tok_s']:.1f} tok/s), the card {base['dev_ms']:.3f} / "
        f"{mixed['dev_ms']:.3f} ms a position (graph replays) | prefill one prompt a call "
        f"{base['prefill_tok_s']:.1f} / {mixed['prefill_tok_s']:.1f} tok/s | bank {bank_mib:.1f} "
        f"MiB fp32 + {bank_mib / 2:.1f} MiB bf16 | peak {peak:.2f} GiB | LoRA decode body "
        f"{mixed['calls']} calls ({mixed['dispatches']} dispatches, captured) | tokens changed "
        f"against the base per request (adapters {adapters}): {changed} | "
        + ", ".join(f"{k}: {v}" for k, v in verdict.items()))
    say(f"[{RUN_LORA} over HTTP] {smi} | 8 concurrent POST /generate {http['batch_s']:.3f}s "
        f"wall (the direct captured run of the same requests {mixed['wall']:.3f}s, both from a "
        f"fresh engine), tokens equal to the direct run's: {not http['generate']} | /stream "
        f"{http['lines']} lines, equal: {http['stream']} | one /generate alone (request 0, "
        f"{LORA_TOKENS} tokens) {1e3 * http['one_s']:.3f} ms wall, the engine's own "
        f"{1e3 * http['engine_s']:.3f} ms | /health {http['health']} | /submit + /cancel frees "
        f"the slot {http['cancel']} | the worker's LoRA decode body {http['calls']} calls, "
        f"captured {http['captured']}; server and worker stopped {http['stopped']} | "
        f"{time.perf_counter() - t0:.2f}s")
    del params, bank
    _free(torch)
    return {label: run["counts"] for label, run in (
        (RUN_LORA_BASE, base), (RUN_LORA, mixed), (RUN_LORA_ONES, ones))}


RUN_8B_INT8 = "phase 4 serve Llama-3-8B int8, fp8 KV"
RUN_8B_ONE = "phase 4 serve Llama-3-8B int8, fp8 KV, one prompt a prefill call"
RUN_CHUNK = "phase 4c serve Llama-3-8B int8, fp8 KV, prefill_chunk_size 512"
RUN_8B_W4A8 = "phase 5 serve Llama-3-8B W4A8 + W8A8 head, fused, fp8 KV"
RUN_70B = "phase 6 serve Llama-3-70B int4 + W8A8 head, fused, fp8 KV"
RUN_SP_DECODE = ("phase 23a serve Llama-3-8B int8, fp8 KV, capacity 131072 sharded over "
                 "sp=4, chunks of 4096")
RUN_SP_PLAIN = "phase 23a serve Llama-3-8B int8, fp8 KV, capacity 131072 unsharded, chunks of 4096"
RUN_TP = "phase 23b serve Llama-3-70B int4 g=128 + W8A8 head, fp8 KV, tp=4"
RUN_PAGED = "phase 7 serve Llama-3-8B int8, fp8 KV, paged + prefix cache"
RUN_SPEC_NGRAM = "phase 9a serve Llama-3-8B int8, fp8 KV, n-gram speculation"
RUN_SPEC_SELF = "phase 9b serve Llama-3-8B int8, bf16 KV, self-draft speculation"
RUN_SPEC_3B = "phase 9c serve Llama-3-8B int8, fp8 KV, Llama-3.2-3B-width draft"
RUN_SAMPLED = "phase 4s serve Llama-3-8B int8, fp8 KV, temperature 0.8, top_k 50"
RUN_RECAPTURE = "phase 4r serve 2 layers at 8B widths, int8, fp8 KV, head changed between waves"
RUN_TRAIN = (f"phase 8 train Llama-3 8B widths, {TRAIN_LAYERS} layers, B=1 S={TRAIN_SEQ}, "
             f"{TRAIN_STEPS} AdamW steps")
RUN_GEMMA = "phase 10 serve Gemma-2-9B int8, fp8 KV"
RUN_GEMMA_TRAIN = (f"phase 11 train Gemma-2 9B widths, {GEMMA_TRAIN_LAYERS} layers, B=1 "
                   f"S={GEMMA_TRAIN_SEQ}, {TRAIN_STEPS} AdamW steps")
RUN_GEMMA27 = "phase 14 serve Gemma-2-27B int8, fp8 KV"
RUN_GEMMA27_TRAIN = (f"phase 15 train Gemma-2 27B widths, {GEMMA27_TRAIN_LAYERS} layers, B=1 "
                     f"S={GEMMA_TRAIN_SEQ}, {TRAIN_STEPS} AdamW steps")
RUN_GPT2 = "phase 12 serve GPT-2 124M bf16, int8 KV"
RUN_GPT2_FP8 = "phase 12 serve GPT-2 124M bf16, fp8 KV"
RUN_GPT2_CHUNK = "phase 12 serve GPT-2 124M bf16, int8 KV, prefill_chunk_size 256"
RUN_GPT2_PACKED = "phase 12 serve GPT-2 124M bf16, int8 KV, packed prefill (capacity 4096)"
RUN_GPT2_PAGED = "phase 12 serve GPT-2 124M bf16, int8 KV, paged"
RUN_GPT2_SPEC = "phase 12 serve GPT-2 124M bf16, int8 KV, n-gram speculation"
RUN_GPT2_BASE = ("phase 12 BASELINE config 0: GPT-2 124M bf16, int8 KV, batch 1, "
                 "1024 positions")
RUN_GPT2_TRAIN = (f"phase 13 train GPT-2 124M bf16, 12 layers, B=8 S=1024, {TRAIN_STEPS} AdamW "
                  "steps")
RUN_QWEN = "phase 16 serve Qwen-2-7B int8, fp8 KV"
RUN_QWEN_ONE = "phase 16 serve Qwen-2-7B int8, fp8 KV, one prompt a prefill call"
RUN_QWEN_CHUNK = "phase 16 serve Qwen-2-7B int8, fp8 KV, prefill_chunk_size 512"
RUN_QWEN_PAGED = "phase 16 serve Qwen-2-7B int8, fp8 KV, paged + prefix cache"
RUN_QWEN_SPEC = "phase 16 serve Qwen-2-7B int8, fp8 KV, n-gram speculation"
RUN_MIXTRAL = "phase 17 serve Mixtral-8x7B int8, fp8 KV"
RUN_MISTRAL = "phase 25 serve Mistral-7B-v0.1 int8, fp8 KV, capacity 8192"
RUN_MISTRAL_EAGER = f"{RUN_MISTRAL}, eager"
RUN_MISTRAL_CHUNK = f"{RUN_MISTRAL}, prefill_chunk_size 512"
RUN_MISTRAL_PAGED = f"{RUN_MISTRAL}, paged + prefix cache"
RUN_MISTRAL_SPEC = f"{RUN_MISTRAL}, n-gram speculation"
RUN_MIXTRAL_SPEC = "phase 17 serve Mixtral-8x7B int8, fp8 KV, n-gram speculation"
RUN_MIXTRAL_PAGED = "phase 17 serve Mixtral-8x7B int8, fp8 KV, paged"
RUN_ABI = ("phase 18 the C entry points, Llama-3-8B attention widths (varlen 8 sequences in "
           "8192, dense B=2 S=2048) and GPT-2's (B=4 S=1024)")
RUN_MIXTRAL_TRAIN = (f"phase 24 train Mixtral-8x7B widths, {MIXTRAL_TRAIN_LAYERS} layers, B=1 "
                     f"S={TRAIN_SEQ}, {TRAIN_STEPS} AdamW steps, remat")
RUN_MIXTRAL_PACKED_TRAIN = (f"phase 24 packed training Mixtral-8x7B widths, "
                            f"{MIXTRAL_TRAIN_LAYERS} layers, B=1 S={TRAIN_SEQ}, documents "
                            f"{PACKED_DOCS}, {MIXTRAL_PACKED_STEPS} AdamW steps")
RUN_PACKED_TRAIN = (f"phase 19 packed training Llama-3 8B widths, {TRAIN_LAYERS} layers, B=1 "
                    f"S={TRAIN_SEQ}, documents (1024, 512, 320, 192), {TRAIN_STEPS} AdamW steps")
RUN_SP_RING = (f"phase 20 ring attention, contiguous, causal, {SP_N} ranks on one card, "
               f"S={SP_S}, forward + backward")
RUN_SP_STRIPED = (f"phase 20 ring attention, striped, causal, {SP_N} ranks on one card, "
                  f"S={SP_S}, forward + backward")
RUN_SP_WINDOW = (f"phase 20 ring attention, contiguous, causal, window {SP_WINDOW}, {SP_N} ranks "
                 f"on one card, S={SP_S}, forward + backward")
RUN_MISTRAL_TRAIN = (f"phase 26 train Mistral-7B-v0.1, 32 layers, B=1 S={MISTRAL_TRAIN_SEQ}, "
                     f"documents {MISTRAL_TRAIN_DOCS}, window {MISTRAL_WINDOW}, {TRAIN_STEPS} "
                     f"AdamW steps, remat")
RUN_SP_RDMA = f"phase 20 rdma ring attention (K11), causal, {SP_N} ranks on one card, S={SP_S}"
RUN_LORA = (f"phase 21 serve Llama-3-8B int8 fused, fp8 KV, a bank of {LORA_ADAPTERS} "
            f"rank-{LORA_RANK} LoRA adapters, request i on adapter i % {LORA_ADAPTERS}")
RUN_LORA_BASE = "phase 21 serve Llama-3-8B int8 fused, fp8 KV, no bank, one prompt a prefill call"
RUN_LORA_ONES = (f"phase 21 serve Llama-3-8B int8 fused, fp8 KV, a bank of {LORA_ADAPTERS} "
                 f"rank-{LORA_RANK} LoRA adapters, every request on adapter 1")
RUN_SP_ULYSSES = (f"phase 20 Ulysses attention, causal, {SP_N} ranks on one card, S={SP_S}, "
                  "forward + backward")
RUN_SURFACE = ("phase 22 the FA2 surface through flash_attention, flash_attention_varlen and the "
               "ring (ALiBi, dbias, return_softmax, auto)")
# BASELINE config 3: Llama-3-8B at 128k context, the KV cache sharded over
# the sequence (sp=4 logical ranks of the card)
SP_CAPACITY, SP_BATCH, SP_CHUNK, SP_TOKENS = 131072, 2, 4096, 24
SP_PROMPTS = (36000, 1000)  # across the boundary of shards 0 and 1; in shard 0 alone
FORCED_STEPS = 16
# BASELINE config 4: Llama-3-70B int4 + fp8 KV at tp=4
TP_N, TP_STEPS, TP_TOKENS = 4, 8, 16
MAX_TP_GIB = 75.0
# the expert-parallel check: Mixtral-8x7B's widths, 64 tokens
MOE_T, MOE_H, MOE_F, MOE_E = 64, 4096, 14336, 8


def _long_prompts(vocab):
    import numpy as np

    rng = np.random.default_rng(SEED + 41)
    lens = np.asarray(SP_PROMPTS)
    return lens, [rng.integers(0, vocab, int(n)).tolist() for n in lens]


def _forced_cache(torch, cfg, params, prompts, capacity, chunk):
    """An fp8 cache holding ``prompts``, one a slot, fed through
    prefill_chunk in pieces of ``chunk`` (so the [1, C, V] fp32 logits stay
    one piece's), the lengths set after."""
    from flash_attn_tpu_torch.models import llama

    cache = llama.make_cache(cfg, len(prompts), capacity, mode="fp8", device="cuda")
    for slot, p in enumerate(prompts):
        toks = torch.tensor([p], device="cuda")
        for start in range(0, len(p), chunk):
            llama.prefill_chunk(params, toks[:, start:start + chunk], cfg, cache, slot, start)
        cache.set_length(slot, len(p))
    return cache


def _logit_rule(torch, checks, label, got, ref):
    """Phase 3's rule: every logit within 5 % of the reference's largest
    (lists of [B, V] logits, one a step); held in ``checks`` unless it is
    None.  Returns (ok, a line of the numbers)."""
    got = torch.stack([x.float() for x in got])
    ref = torch.stack([x.float() for x in ref])
    err = float((got - ref).abs().max())
    tol = 5e-2 * float(ref.abs().max())
    finite = bool(got.isfinite().all())
    ok = (err <= tol if checks is None else checks.check(label, err, tol)) and finite
    if checks is not None and not finite:
        checks.failed.append(f"{label}: logits not finite")
    agree = int((got.argmax(-1) == ref.argmax(-1)).sum())
    return ok, (f"max_abs_err {err:.3e} (tol {tol:.3e}, max |logit| "
                f"{float(ref.abs().max()):.3f}), greedy agreement {agree}/{ref.shape[0] * ref.shape[1]}")


def _step_counts(torch, fn):
    """Each kernel's launches in one call of ``fn`` (the counts set to 0
    just before, read just after)."""
    _reset_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, _read_counts()


def phase_sp_decode(torch, checks, smi):
    """23a. BASELINE config 3: Llama-3-8B int8, fp8 KV, capacity 131072
    sharded over sp=4 logical ranks of the card (each rank's 32768
    positions a view of the one buffer), max_batch 2, prompts of 36000
    tokens (across the first shard boundary) and 1000 (shards 1-3 empty),
    fed through chunked prefill in pieces of 4096.  Teacher-forced: 16
    steps of decode_step_sharded and decode_step from the same cache state
    and tokens, held by phase 3's rule, the launches of one sharded step
    exact (K1 = 4 x 32, K1m = 32, K2 = 32), eager ms a position of each;
    then the mesh engine captured (launches exact: K1 4 x 32 and K1m 32 a
    step) and the unsharded engine on the same prompts, their greedy
    tokens' agreement printed; peak memory.  Returns {run: counts}."""
    import numpy as np

    from flash_attn_tpu_torch.models import llama
    from flash_attn_tpu_torch.parallel import mesh as pm

    t0 = time.perf_counter()
    cfg = llama.LLAMA3_8B
    L = cfg.num_layers
    params, secs = _fresh_model(torch, cfg, quantize="int8")
    mesh = pm.make_mesh(pm.MeshConfig(sp=SP_N), devices=["cuda:0"] * SP_N)
    lens, prompts = _long_prompts(cfg.vocab_size)
    cache = _forced_cache(torch, cfg, params, prompts, SP_CAPACITY, SP_CHUNK)
    rng = np.random.default_rng(SEED + 43)
    forced = torch.tensor(rng.integers(0, cfg.vocab_size, (FORCED_STEPS, SP_BATCH)),
                          device="cuda")
    got, ref = [], []
    for s in range(FORCED_STEPS):
        (a, _), counts = _step_counts(torch, lambda: llama.decode_step_sharded(
            params, forced[s], cfg, cache, mesh))
        if s == 0:
            one = counts_of(counts, ("K1", "K1 view", "K1m", "K2"))
            _launches_exact(checks, "phase 23 config 3 sharded step", counts,
                         {"K1": SP_N * L, "K1 view": SP_N * L, "K1m": L, "K2": L})
        cache.length -= 1
        b, _ = llama.decode_step(params, forced[s], cfg, cache)
        got.append(a)
        ref.append(b)
    ok, line = _logit_rule(torch, checks, "phase 23 config 3 sharded vs unsharded logits", got, ref)

    def eager_ms(step):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for s in range(8):
            step(forced[s])
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t) / 8

    sharded_ms = eager_ms(lambda tok: llama.decode_step_sharded(params, tok, cfg, cache, mesh))
    plain_ms = eager_ms(lambda tok: llama.decode_step(params, tok, cfg, cache))
    peak = torch.cuda.max_memory_allocated() / 2**30
    say(f"[phase 23 config 3 teacher-forced, {smi}] Llama-3-8B int8, fp8 KV, capacity "
        f"{SP_CAPACITY} over sp={SP_N} ranks of the card, prompts {lens.tolist()} in chunks of "
        f"{SP_CHUNK}, {FORCED_STEPS} steps: {line} {'ok' if ok else 'FAIL'} | one sharded step "
        f"launches {one} | eager {sharded_ms:.3f} ms a position sharded, {plain_ms:.3f} "
        f"unsharded | peak {peak:.2f} GiB | {time.perf_counter() - t0:.2f}s")
    del cache
    _free(torch)
    kw = dict(capacity=SP_CAPACITY, prompts=(lens, prompts), max_batch=SP_BATCH, chunk=SP_CHUNK,
              packed=False)
    path = ("K1", "K1m", "K2", "K3", "K4")
    torch.cuda.reset_peak_memory_stats()
    run = serve(torch, checks, RUN_SP_DECODE, cfg, params, "fp8", SP_TOKENS, path,
                adapter=llama.make_adapter(cfg, mesh=mesh), mesh=mesh, **kw)
    steps = run["calls"]
    _launches_exact(checks, RUN_SP_DECODE, run["counts"],
                 {"K1": SP_N * L * steps, "K1 view": SP_N * L * steps, "K1m": L * steps,
                  "K2": L * steps})
    torch.cuda.reset_peak_memory_stats()
    plain = serve(torch, checks, RUN_SP_PLAIN, cfg, params, "fp8", SP_TOKENS, path, **kw)
    same = [sum(a == b for a, b in zip(x, y)) for x, y in zip(run["tokens"], plain["tokens"])]
    first = [next((i for i, (a, b) in enumerate(zip(x, y)) if a != b), len(x))
             for x, y in zip(run["tokens"], plain["tokens"])]
    say(f"[phase 23 config 3 engines, {smi}] mesh engine captured {run['pos_ms']:.3f} ms a "
        f"position (the card {run['dev_ms'] or 0:.3f}), peak {run['peak']:.2f} GiB; unsharded "
        f"{plain['pos_ms']:.3f} (the card {plain['dev_ms'] or 0:.3f}), peak {plain['peak']:.2f} "
        f"GiB | greedy tokens equal {same} of {SP_TOKENS} a request, the first difference at "
        f"{first} | {steps} decode steps, launches K1 {run['counts']['K1']} K1m "
        f"{run['counts']['K1m']} | {time.perf_counter() - t0:.2f}s")
    del params
    _free(torch)
    return {RUN_SP_DECODE: run["counts"], RUN_SP_PLAIN: plain["counts"]}


def _unfuse(blk, cfg):
    """A fused Llama block's wqkv and w_gate_up split back into wq, wk,
    wv, w_gate and w_up (int4 halves: every column stands alone, so the
    column slices are the unfused weights)."""
    from flash_attn_tpu_torch.ops.quant import Int4Weight

    def cols(w, lo, hi):
        return Int4Weight(w.packed[:, lo:hi].contiguous(), w.scales[:, lo:hi].contiguous(),
                          w.group_size, (w.shape[0], hi - lo))

    q, kv, f = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim, cfg.intermediate
    nb = {k: v for k, v in blk.items() if k not in ("wqkv", "w_gate_up")}
    w = blk["wqkv"]
    nb.update(wq=cols(w, 0, q), wk=cols(w, q, q + kv), wv=cols(w, q + kv, q + 2 * kv))
    w = blk["w_gate_up"]
    nb.update(w_gate=cols(w, 0, f), w_up=cols(w, f, 2 * f))
    return nb


def phase_tp(torch, checks, smi, params):
    """23b. BASELINE config 4: phase 6's Llama-3-70B (int4 g=128 fused, W8A8
    head) unfused and then sharded at tp=4 over logical ranks of the card,
    layer by layer, each unsharded layer dropped as it is sharded.
    Teacher-forced: two prompts (600 and 300 tokens, fp8 KV) and 8 decode
    steps on the same tokens at tp=1 fused, tp=1 unfused and tp=4.  Phase
    3's rule is held where it holds for the card against the CPU: on the
    first 2 layers of the same weights (tp=4 against tp=1 unfused).  Over
    all 80 random layers a rounding difference grows: the errors of tp=4
    and of the fused tree (the same function as the unfused, summed in
    another order by K6) against the unfused are printed side by side.
    K6 and K7 launches a step at tp=4 must be 4 x tp=1's (unfused).  Then
    the sharded params served captured (phase 4's prompts, 16 tokens, fp8
    KV): ms a position, peak under 75 GiB.  Empties ``params``.  Returns
    {run: counts}."""
    import numpy as np

    from flash_attn_tpu_torch.models import llama
    from flash_attn_tpu_torch.parallel import mesh as pm
    from flash_attn_tpu_torch.parallel import tp

    t0 = time.perf_counter()
    cfg = llama.LLAMA3_70B
    rng = np.random.default_rng(SEED + 44)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (600, 300)]
    forced = torch.tensor(rng.integers(0, cfg.vocab_size, (TP_STEPS, 2)), device="cuda")

    def forced_run(p, layers=None):
        c = cfg if layers is None else dataclasses.replace(cfg, num_layers=layers)
        if layers is not None:
            p = dict(p, blocks=p["blocks"][:layers])
        cache = _forced_cache(torch, c, p, prompts, 1024, 1024)
        logits, per_step = [], None
        for s in range(TP_STEPS):
            (out, _), counts = _step_counts(torch, lambda: llama.decode_step(p, forced[s], c,
                                                                             cache))
            logits.append(out)
            per_step = per_step or counts_of(counts, ("K6", "K7", "K1", "K2"))
        del cache
        return logits, per_step

    fused, _ = forced_run(params)
    blocks = params["blocks"]
    for i in range(len(blocks)):
        blocks[i] = _unfuse(blocks[i], cfg)
    torch.cuda.empty_cache()
    ref, one = forced_run(params)
    ref2, _ = forced_run(params, 2)
    mesh = pm.make_mesh(pm.MeshConfig(tp=TP_N), devices=["cuda:0"] * TP_N)
    t1 = time.perf_counter()
    sharded = tp.shard_params_quant(params, mesh, consume=True)
    torch.cuda.synchronize()
    shard_s = time.perf_counter() - t1
    torch.cuda.empty_cache()
    got, four = forced_run(sharded)
    got2, _ = forced_run(sharded, 2)
    ok, line2 = _logit_rule(torch, checks, "phase 23 config 4 tp=4 vs tp=1 logits, 2 layers",
                            got2, ref2)
    ok &= _launches_exact(checks, "phase 23 config 4 launches a step", four,
                       {"K6": TP_N * one["K6"], "K7": TP_N * one["K7"], "K1": one["K1"],
                        "K2": one["K2"]})
    _, line80 = _logit_rule(torch, None, "", got, ref)
    _, line_fused = _logit_rule(torch, None, "", fused, ref)
    say(f"[phase 23 config 4 teacher-forced, {smi}] Llama-3-70B int4 g=128 + W8A8 head, fp8 KV, "
        f"tp={TP_N} ranks of the card (80 layers, sharded in {shard_s:.2f}s), prompts 600 and 300, "
        f"{TP_STEPS} steps: 2 layers, tp={TP_N} against tp=1: {line2} {'ok' if ok else 'FAIL'} | "
        f"80 layers (printed, not held): tp={TP_N} against tp=1 unfused {line80}; tp=1 fused "
        f"against unfused {line_fused} | launches a step tp=1 {one}, tp={TP_N} {four}")
    del ref, got, ref2, got2, fused
    torch.cuda.reset_peak_memory_stats()
    run = serve(torch, checks, RUN_TP, cfg, sharded, "fp8", TP_TOKENS,
                ("K1", "K1m", "K2", "K4", "K6", "K7"))
    if run["peak"] > MAX_TP_GIB:
        checks.failed.append(f"{RUN_TP}: peak {run['peak']:.2f} GiB > {MAX_TP_GIB} GiB")
    say(f"[{RUN_TP}, {smi}] captured {run['pos_ms']:.3f} ms a position (the card "
        f"{run['dev_ms'] or 0:.3f}), peak {run['peak']:.2f} GiB against {MAX_TP_GIB} | "
        f"{time.perf_counter() - t0:.2f}s")
    del sharded
    _free(torch)
    return {RUN_TP: run["counts"]}


def phase_ep_pp(torch, checks, smi):
    """23c. Expert parallelism at Mixtral-8x7B's widths (H=4096, F=14336,
    E=8, top 2) over tp=4 logical ranks of the card, 64 tokens:
    moe_ffn_ep and moe_ffn_ep_a2a (capacity 32, nothing drops) against
    moe_ffn_reference on the card by the row rule; then pipeline_spmd with
    4 stages (a 1024 x 1024 fp32 matmul and tanh each) over 8
    microbatches against the stages applied in sequence to each
    microbatch (fp32, the same kernels on the same operands: 1e-6 of the
    largest output)."""
    from flash_attn_tpu_torch.parallel import mesh as pm
    from flash_attn_tpu_torch.parallel import moe, pp

    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(SEED + 45)

    def rnd(*shape, s=1.0):
        return torch.randn(shape, generator=g, device="cuda", dtype=torch.bfloat16) * s

    x, router = rnd(MOE_T, MOE_H), rnd(MOE_H, MOE_E)
    wg, wu = rnd(MOE_E, MOE_H, MOE_F, s=0.02), rnd(MOE_E, MOE_H, MOE_F, s=0.02)
    wd = rnd(MOE_E, MOE_F, MOE_H, s=0.02)
    mesh = pm.make_mesh(pm.MeshConfig(tp=TP_N), devices=["cuda:0"] * TP_N)
    ref = moe.moe_ffn_reference(x, router, wg, wu, wd, top_k=2)
    parts = []
    for name, fn in (("moe_ffn_ep", moe.make_moe_ffn(mesh, top_k=2)),
                     ("moe_ffn_ep_a2a", moe.make_moe_ffn_a2a(mesh, axis_name="tp", top_k=2,
                                                             capacity=MOE_T // TP_N * 2))):
        got = fn(x, router, wg, wu, wd)
        ms = cuda_ms(torch, lambda: fn(x, router, wg, wu, wd), iters=5, warmup=1)
        err, share = row_err(got, ref)
        ok = checks.check(f"phase 23 {name}", share, 1.0)
        parts.append(f"{name} max_abs_err {err:.3e} ({share:.3f} of its row's tol) "
                     f"{'ok' if ok else 'FAIL'}, {ms:.3f} ms")
    ref_ms = cuda_ms(torch, lambda: moe.moe_ffn_reference(x, router, wg, wu, wd, top_k=2),
                     iters=5, warmup=1)
    del wg, wu, wd
    smesh = pm.make_mesh(pm.MeshConfig(sp=TP_N), devices=["cuda:0"] * TP_N)
    ws = [torch.randn((1024, 1024), generator=g, device="cuda") / 32 for _ in range(TP_N)]
    xs = torch.randn((8, 16, 1024), generator=g, device="cuda")

    def stage(w, h):
        return torch.tanh(h @ w)

    got = pp.pipeline_spmd(stage, ws, xs, mesh=smesh, axis_name="sp", num_microbatches=8)
    want = []
    for h in xs:  # microbatch by microbatch, as the stages see them
        for w in ws:
            h = stage(w, h)
        want.append(h)
    want = torch.stack(want)
    perr = float((got - want).abs().max())
    ok = checks.check("phase 23 pipeline_spmd", perr, 1e-6 * float(want.abs().max()))
    say(f"[phase 23 expert parallel and pipeline, {smi}] Mixtral widths H={MOE_H} F={MOE_F} "
        f"E={MOE_E} top 2, {MOE_T} tokens over tp={TP_N}: " + "; ".join(parts)
        + f"; moe_ffn_reference {ref_ms:.3f} ms | pipeline_spmd {TP_N} stages x 8 microbatches "
        f"max_abs_err {perr:.3e} {'ok' if ok else 'FAIL'} | {time.perf_counter() - t0:.2f}s")
    _free(torch)


KERNEL_ROWS = ("K1", "K1m", "K1c", "K1b", "K2", "K3", "K3g", "K4", "K5", "K6", "K7", "K8", "K8c",
               "K9", "K10", "K4 d256", "K1 d256", "K2 d256", "K1m d256", "K9 d256", "K10 d256",
               "K4 d64", "K1 d64", "K1c d64", "K8 d64", "K2 d64", "K1m d64", "K9 d64", "K10 d64",
               "K4 27B", "K1 27B", "K9 27B", "K10 27B", "K4 G7", "K1 G7", "K1c G7", "K8 G7",
               "K2 G7", "K3 Mixtral", "K4 opt", "K9 opt", "K10 opt", "K11", "K4 surface",
               "K9 surface", "K10 surface", "K1 shard", "K6 tp4", "K7 tp4", "K4 local seg",
               "K1c window", "K8 window", "K8c window", "K4 local seg idx", "K9 local seg",
               "K10 local seg")
# the run whose launches a kernel's row reports, and the count it reads:
# the main path that the kernel serves (the 70B serve for the shared K1,
# K1m, K2 and K4, the n-gram speculative serve for K1's chunk mode, the
# paged serve for K8 in both modes, the training run for K9 and K10, the
# captured Gemma-2-9B serve for the head_dim 256 points of K4, K1, K2 and
# K1m, the Gemma-2 training run for K9's and K10's, the GPT-2 training run
# for their head_dim 64 points, the captured Gemma-2-27B serve and its
# training run for the head_dim 128 kLocal points, the Qwen-2-7B serve's
# runs for the 7-heads-a-KV-head points, the captured Mixtral-8x7B serve for
# K3 at its experts' widths, the Mistral-7B training run for the windowed
# training instances); K3 grouped and K1 over a BSHD cache have no model
# path, so their rows report none
ROW_RUN = {"K1": RUN_70B, "K1m": RUN_70B, "K1c": RUN_SPEC_NGRAM, "K1b": None, "K2": RUN_70B,
           "K3": RUN_8B_INT8, "K3g": None, "K4": RUN_70B, "K5": RUN_8B_W4A8, "K6": RUN_70B,
           "K7": RUN_70B, "K8": RUN_PAGED, "K8c": RUN_PAGED, "K9": RUN_TRAIN, "K10": RUN_TRAIN,
           "K4 d256": RUN_GEMMA, "K1 d256": RUN_GEMMA, "K2 d256": RUN_GEMMA,
           "K1m d256": RUN_GEMMA, "K9 d256": RUN_GEMMA_TRAIN, "K10 d256": RUN_GEMMA_TRAIN,
           "K4 d64": RUN_GPT2, "K1 d64": RUN_GPT2, "K1c d64": RUN_GPT2_SPEC,
           "K8 d64": RUN_GPT2_PAGED, "K2 d64": RUN_GPT2, "K1m d64": RUN_GPT2,
           "K9 d64": RUN_GPT2_TRAIN, "K10 d64": RUN_GPT2_TRAIN, "K4 27B": RUN_GEMMA27,
           "K1 27B": RUN_GEMMA27, "K9 27B": RUN_GEMMA27_TRAIN, "K10 27B": RUN_GEMMA27_TRAIN,
           "K4 G7": RUN_QWEN, "K1 G7": RUN_QWEN, "K1c G7": RUN_QWEN_SPEC,
           "K8 G7": RUN_QWEN_PAGED, "K2 G7": RUN_QWEN, "K3 Mixtral": RUN_MIXTRAL,
           "K4 opt": RUN_ABI, "K9 opt": RUN_ABI, "K10 opt": RUN_ABI, "K11": RUN_SP_RDMA,
           "K4 surface": RUN_SURFACE, "K9 surface": RUN_SURFACE, "K10 surface": RUN_SURFACE,
           "K1 shard": RUN_SP_DECODE, "K6 tp4": RUN_TP, "K7 tp4": RUN_TP,
           "K4 local seg": RUN_MISTRAL, "K1c window": RUN_MISTRAL_SPEC,
           "K8 window": RUN_MISTRAL_PAGED, "K8c window": RUN_MISTRAL_PAGED,
           "K4 local seg idx": RUN_MISTRAL_TRAIN, "K9 local seg": RUN_MISTRAL_TRAIN,
           "K10 local seg": RUN_MISTRAL_TRAIN}
# a row's count where it is not the row's own key: every K2 and K1m launch
# of the Gemma-2-9B serve is at head_dim 256, and every launch of the GPT-2
# serves at head_dim 64 (phase 12 holds the d64 counts equal); the 27B
# rows read their runs' kLocal counts (K1's: all of phase 14's)
ROW_COUNT = {"K2 d256": "K2", "K1m d256": "K1m", "K4 d64": "K4", "K1 d64": "K1",
             "K1c d64": "K1c", "K8 d64": "K8", "K2 d64": "K2", "K1m d64": "K1m",
             "K4 27B": "K4 local", "K1 27B": "K1", "K9 27B": "K9 local", "K10 27B": "K10 local",
             "K4 G7": "K4", "K1 G7": "K1", "K1c G7": "K1c", "K8 G7": "K8", "K2 G7": "K2",
             "K3 Mixtral": "K3", "K4 opt": "K4 extra", "K1 shard": "K1", "K6 tp4": "K6",
             "K7 tp4": "K7", "K1c window": "K1c local", "K8 window": "K8 local",
             "K8c window": "K8c local", "K4 local seg idx": "K4 local seg",
             "K9 local seg": "K9 local", "K10 local seg": "K10 local"}


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
    for case in CARD_VS_CPU:
        card_vs_cpu(torch, checks, *case)
    prefill_card_vs_cpu(torch, checks)
    paged_card_vs_cpu(torch, checks)
    multi_card_vs_cpu(torch, checks)
    lora_card_vs_cpu(torch, checks)
    train_card_vs_cpu(torch, checks)
    gemma_card_vs_cpu(torch, checks)
    gemma_train_card_vs_cpu(torch, checks)
    gemma_card_vs_cpu(torch, checks, "27B", SEED + 21)
    gemma_train_card_vs_cpu(torch, checks, "27B", SEED + 22)
    gpt2_card_vs_cpu(torch, checks)
    gpt2_train_card_vs_cpu(torch, checks)
    qwen_card_vs_cpu(torch, checks)
    mistral_card_vs_cpu(torch, checks)
    mistral_train_card_vs_cpu(torch, checks)
    mixtral_card_vs_cpu(torch, checks, "int8", SEED + 66)
    mixtral_card_vs_cpu(torch, checks, "int4", SEED + 67)
    mixtral_train_card_vs_cpu(torch, checks)
    runs = {RUN_ABI: phase_abi(torch, checks, smi)}
    runs.update(phase_sp(torch, checks, smi))
    runs.update(phase_fa2_surface(torch, checks, smi))
    runs.update(phase_serve(torch, checks, smi))
    runs.update(phase_gemma(torch, checks, smi))
    runs.update(phase_gemma(torch, checks, smi, "27B"))
    runs[RUN_TRAIN] = phase_train(torch, checks, smi)
    runs[RUN_PACKED_TRAIN] = phase_packed_train(torch, checks, smi)
    runs[RUN_GEMMA_TRAIN] = phase_gemma_train(torch, checks, smi)
    runs[RUN_GEMMA27_TRAIN] = phase_gemma_train(torch, checks, smi, "27B")
    runs.update(phase_gpt2(torch, checks, smi))
    runs[RUN_GPT2_TRAIN] = phase_gpt2_train(torch, checks, smi)
    runs.update(phase_qwen(torch, checks, smi))
    runs.update(phase_mixtral(torch, checks, smi))
    runs.update(phase_mistral(torch, checks, smi))
    runs.update(phase_mixtral_train(torch, checks, smi))
    runs.update(phase_mistral_train(torch, checks, smi))
    runs.update(phase_lora(torch, checks, smi))
    runs.update(phase_sp_decode(torch, checks, smi))
    phase_ep_pp(torch, checks, smi)
    for key, row in rows.items():
        row["launches_run"] = ROW_RUN[key]
        row["launches"] = runs[ROW_RUN[key]][ROW_COUNT.get(key, key)] if ROW_RUN[key] else 0
    say(f"[total] {time.perf_counter() - t_start:.2f}s")
    if checks.failed:
        for f in checks.failed:
            print("FAILED " + f, file=sys.stderr)
        return 1
    kernels = [dict(name=r["name"], route="cuda", source=r["source"],
                    replaces=r["replaces"], launches=r["launches"],
                    launches_run=r["launches_run"],
                    max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
                    bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                    library_ms=r["library_ms"],
                    **{k: r[k] for k in ("graph_ms", "library_graph_ms", "call_graph_ms",
                                         "empty_graph_ms",
                                         "prompt", "also", "packed", "chunk", "gemma",
                                         "gemma27b", "qwen2",
                                         "sdpa_nocap_ms", "no_window", "k8c", "sdpa_mask_ms",
                                         "bound_per_head_ms", "no_mask", "segments", "dense",
                                         "bias", "d64", "d64_varlen", "d64_segments",
                                         "readout", "bound_f32_ms", "bound_bf16_ms",
                                         "non_causal", "gpt2", "probs", "verify", "dbias",
                                         "library_backend", "slices", "softcap")
                       if k in r})
               for r in (rows[k] for k in KERNEL_ROWS)]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
