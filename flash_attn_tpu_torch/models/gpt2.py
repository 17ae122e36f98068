"""GPT-2 in PyTorch for serving and training: learned position
embeddings, pre-norm LayerNorm blocks, fused QKV and MLP projections with
biases, tanh GELU, multi-head attention at head_dim 64 (124M: 12 heads of
64, hidden 768) without rope, and the tied embedding as an fp32 head,
over the port's kernels (prefill K4, also with segment ids (packed) and
positions (chunked); decode K1 + K2; the speculative verify step K1c;
paged decode K8; the training backward K9 + K10), all at head_dim 64.

Port of flash_attn_tpu/models/gpt2.py: ``GPT2Config``, ``GPT2_124M``,
``GPT2_TINY``, ``init_params`` (from a ``torch.Generator``), ``forward``,
``max_attention_logit``, ``prefill``, ``decode_step``, ``decode_multi``,
``prefill_chunk``, ``decode_step_paged``, ``prefill_with_kv``,
``prefill_packed``, ``make_adapter``, ``make_cache``, ``greedy_decode``,
``load_hf`` and ``convert_hf_state_dict``.  Params are the JAX pytree as a
plain dict: ``wte``, ``wpe``, ``ln_f`` and per block ``ln_1``, ``attn``
(``qkv``, ``proj``), ``ln_2``, ``mlp`` (``fc``, ``proj``), each dense a
``{"w": [in, out], "b": [out]}`` pair (HF's Conv1D orientation).

As in JAX, LayerNorm and every dense layer compute in fp32 and round back
to the activation dtype, and the head is the embedding, transposed, in
fp32 (the serving paths keep it in the params dict under
``"_lm_head_f32"``, as ``models/llama.py`` keeps its head's; ``forward``
reads the live embedding and caches nothing).  A position past the table's end
reads its last row, as JAX's clamped gather does: an idle slot's length
runs past the capacity, and so past ``max_position`` when the two are
equal.

``GPT2_124M`` is float32, as in JAX; on the card the kernels take bf16
only, so BASELINE config 0 ("BF16 weights + INT8 KV-cache") runs
``dataclasses.replace(GPT2_124M, dtype="bfloat16")``, and an fp32 model
on the card raises from the kernels' dtype checks.  ``forward`` is the
training forward, differentiable w.r.t. every float param (the tied
``wte`` takes the gradients of the gather and of the head), with
per-block checkpointing under ``remat``; the serving paths run under
``torch.no_grad()``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.utils.checkpoint import checkpoint

from flash_attn_tpu_torch._device import resolve_device
from flash_attn_tpu_torch.engine.kv_cache import KVCache
from flash_attn_tpu_torch.engine.paged import PagedKVPool, paged_decode_attention
from flash_attn_tpu_torch.models import llama
from flash_attn_tpu_torch.ops.attention import flash_attention
from flash_attn_tpu_torch.ops.decode import flash_decode, flash_decode_chunk

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    max_position: int = 1024
    num_layers: int = 12
    num_heads: int = 12
    hidden: int = 768
    dtype: str = "float32"
    # Softmax statistics of the inference prefills: "clamped" (no running
    # max) is exact for natural-units logits up to ~55; GPT-2 has no
    # qk-norm or softcap, so validate a real checkpoint once with
    # ``max_attention_logit`` and set "online" if it probes above ~50.
    softmax_mode: str = "clamped"

    @property
    def head_dim(self) -> int:
        return self.hidden // self.num_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]


GPT2_124M = GPT2Config()
GPT2_TINY = GPT2Config(
    vocab_size=1024, max_position=128, num_layers=2, num_heads=4, hidden=128
)


def init_params(cfg: GPT2Config, seed: int = 0, *, device=None) -> dict:
    """Random weights from ``seed`` on ``device`` (default: the card):
    dense weights normal * 0.02 with zero biases, LayerNorm gains 1 and
    biases 0, ``wte`` normal * 0.02, ``wpe`` normal * 0.01."""
    dev = resolve_device(device)
    dtype = cfg.torch_dtype
    gen = torch.Generator(device=dev).manual_seed(seed)

    def normal(shape, std):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype) * std

    def dense(kin, kout):
        return {"w": normal((kin, kout), 0.02), "b": torch.zeros(kout, dtype=dtype, device=dev)}

    def ln():
        return {"g": torch.ones(cfg.hidden, dtype=dtype, device=dev),
                "b": torch.zeros(cfg.hidden, dtype=dtype, device=dev)}

    h = cfg.hidden
    blocks = [{"ln_1": ln(), "attn": {"qkv": dense(h, 3 * h), "proj": dense(h, h)},
               "ln_2": ln(), "mlp": {"fc": dense(h, 4 * h), "proj": dense(4 * h, h)}}
              for _ in range(cfg.num_layers)]
    return {"wte": normal((cfg.vocab_size, h), 0.02),
            "wpe": normal((cfg.max_position, h), 0.01),
            "blocks": blocks, "ln_f": ln()}


def _layer_norm(x, p, eps=1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["g"].float() + p["b"].float()).to(x.dtype)


def _dense(x, p):
    return (torch.matmul(x.float(), p["w"].float()) + p["b"].float()).to(x.dtype)


def _embed(params, tokens, positions):
    """wte[tokens] + wpe[positions], a position past the table reading its
    last row (JAX's gather clamps the index)."""
    wpe = params["wpe"]
    return params["wte"][tokens] + wpe[positions.clamp(0, wpe.shape[0] - 1)]


def _qkv(x, blk, cfg):
    """The block's pre-norm and fused QKV projection: q, k, v [B, S, H, D]."""
    b, s, _ = x.shape
    qkv = _dense(_layer_norm(x, blk["ln_1"]), blk["attn"]["qkv"])
    return tuple(t.reshape(b, s, cfg.num_heads, cfg.head_dim).contiguous()
                 for t in qkv.split(cfg.hidden, dim=-1))


def _finish(x, attn, blk, cfg):
    """The attention out projection and the MLP around attention out
    [B, S, H, D]."""
    b, s = attn.shape[:2]
    x = x + _dense(attn.reshape(b, s, cfg.hidden), blk["attn"]["proj"])
    m = torch.nn.functional.gelu(_dense(_layer_norm(x, blk["ln_2"]), blk["mlp"]["fc"]),
                                 approximate="tanh")
    return x + _dense(m, blk["mlp"]["proj"])


def _logits(params, x):
    """The final LayerNorm, then the tied head in fp32 (serving: the
    cached fp32 copy of ``wte``)."""
    x = _layer_norm(x, params["ln_f"])
    return llama._proj(x.float(), llama.f32_head(params, params["wte"], True))


def _block(x, blk, cfg):
    """One block of the training forward: K4 causal with the online
    softmax; its backward K9 + K10."""
    q, k, v = _qkv(x, blk, cfg)
    return _finish(x, flash_attention(q, k, v, causal=True), blk, cfg)


def forward(params, tokens, cfg: GPT2Config, *, remat: bool = False):
    """Full-sequence forward (training): tokens [B, S] -> logits [B, S, V]
    fp32, differentiable w.r.t. every float param; the tied ``wte`` takes
    the gradients of both its uses.  ``remat`` checkpoints each block
    (``torch.utils.checkpoint``): the backward reruns its forward, K4
    included.  ``jax.checkpoint`` of the whole forward, as the JAX train
    step does it, gives the same values.  The head is the live ``wte`` in
    fp32, never the serving paths' cached copy."""
    b, s = tokens.shape
    x = _embed(params, tokens, torch.arange(s, device=tokens.device)[None])
    for blk in params["blocks"]:
        x = checkpoint(_block, x, blk, cfg, use_reentrant=False) if remat else _block(x, blk, cfg)
    x = _layer_norm(x, params["ln_f"])
    return torch.matmul(x.float(), params["wte"].float().T)


@torch.no_grad()
def max_attention_logit(params, tokens, cfg: GPT2Config) -> float:
    """The checkpoint probe for the clamped softmax: the largest |scaled
    attention logit| over every layer and head for a calibration batch
    (O(S^2) memory: use a ~1k-token probe).  Keep
    ``softmax_mode="clamped"`` only if it is comfortably below ~50."""
    b, s = tokens.shape
    x = _embed(params, tokens, torch.arange(s, device=tokens.device)[None])
    worst = 0.0
    causal = torch.tril(torch.ones((s, s), dtype=torch.bool, device=tokens.device))
    for blk in params["blocks"]:
        q, k, v = _qkv(x, blk, cfg)
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * cfg.head_dim ** -0.5
        worst = max(worst, float(torch.where(causal, scores, 0.0).abs().max()))
        x = _finish(x, flash_attention(q, k, v, causal=True), blk, cfg)
    return worst


@torch.no_grad()
def prefill(params, tokens, cfg: GPT2Config, cache: KVCache):
    """The prompt through the model, its K/V appended to the cache at each
    slot's length: tokens [B, S] -> (logits of the last token [B, V] fp32,
    cache), the cache updated in place."""
    b, s = tokens.shape
    pos = cache.length[:, None].long() + torch.arange(s, device=tokens.device)[None]
    x = _embed(params, tokens, pos)
    for i, blk in enumerate(params["blocks"]):
        q, k, v = _qkv(x, blk, cfg)
        cache.append(i, k, v)
        attn = flash_attention(q, k, v, causal=True, softmax_mode=cfg.softmax_mode)
        x = _finish(x, attn, blk, cfg)
    cache.advance(s)
    return _logits(params, x[:, -1]), cache


@torch.no_grad()
def decode_step(params, token, cfg: GPT2Config, cache: KVCache):
    """One cached decode step for every slot: token [B] -> (logits [B, V]
    fp32, cache).  Per layer K2 appends the token's K/V at ``length``, then
    K1 attends over ``length + 1`` positions; ``length`` advances by one
    after the last layer.  The cache is updated in place."""
    x = _embed(params, token[:, None], cache.length[:, None].long())
    kv_length = cache.length + 1
    for i, blk in enumerate(params["blocks"]):
        q, k, v = _qkv(x, blk, cfg)
        cache.append(i, k, v)
        kc, vc, ks, vs = cache.layer(i)
        attn = flash_decode(q[:, 0], kc, vc, k_scale=ks, v_scale=vs, kv_length=kv_length,
                            kv_layout="bhsd")
        x = _finish(x, attn[:, None], blk, cfg)
    cache.advance(1)
    return _logits(params, x[:, 0]), cache


@torch.no_grad()
def decode_multi(params, tokens, cfg: GPT2Config, cache: KVCache):
    """T cached decode tokens per sequence in one pass, the speculative
    verify step: tokens [B, T] -> (logits [B, T, V] fp32, cache).  Per
    layer the chunk's K/V is appended at ``length`` first, then its T
    queries attend to the cache through K1c (causal within the chunk);
    ``length`` advances by T after the last layer."""
    t = tokens.shape[1]
    pos = cache.length[:, None].long() + torch.arange(t, device=tokens.device)[None]
    x = _embed(params, tokens, pos)
    kv_length = cache.length + t
    for i, blk in enumerate(params["blocks"]):
        q, k, v = _qkv(x, blk, cfg)
        cache.append(i, k, v)
        kc, vc, ks, vs = cache.layer(i)
        attn = flash_decode_chunk(q, kc, vc, k_scale=ks, v_scale=vs, kv_length=kv_length,
                                  kv_layout="bhsd")
        x = _finish(x, attn, blk, cfg)
    cache.advance(t)
    return _logits(params, x), cache


@torch.no_grad()
def prefill_chunk(params, tokens, cfg: GPT2Config, cache: KVCache, slot: int, start: int):
    """Chunked prefill: tokens [1, C] at positions [start, start + C) of
    ``slot``.  Per layer the chunk's K/V is written into the cache at
    ``start``, then its queries attend to the slot's whole dequantized
    cache through K4 with positions (the chunk at start + i, the cache at
    its index).  Returns (logits [1, C, V] fp32, cache), the cache updated
    in place."""
    c = tokens.shape[1]
    qpos = start + torch.arange(c, device=tokens.device)[None]
    kvpos = torch.arange(cache.capacity, device=tokens.device)[None]
    x = _embed(params, tokens, qpos)
    for i, blk in enumerate(params["blocks"]):
        q, k, v = _qkv(x, blk, cfg)
        cache.insert_at(i, slot, k[0], v[0], start)
        kc, vc = cache.slot_kv_float(i, slot, dtype=x.dtype)
        attn = flash_attention(q, kc, vc, q_positions=qpos, kv_positions=kvpos,
                               softmax_mode=cfg.softmax_mode)
        x = _finish(x, attn, blk, cfg)
    return _logits(params, x), cache


@torch.no_grad()
def decode_step_paged(params, token, cfg: GPT2Config, pool: PagedKVPool):
    """One decode step for every slot against a paged pool: token [B] ->
    (logits [B, V] fp32, pool).  Per layer the token's K/V is appended at
    ``length``, then K8 attends over ``length + 1`` positions; ``length``
    advances once after the last layer."""
    x = _embed(params, token[:, None], pool.length[:, None].long())
    kv_length = pool.length + 1
    for i, blk in enumerate(params["blocks"]):
        q, k, v = _qkv(x, blk, cfg)
        pool.append_token(i, k[:, 0], v[:, 0])
        attn = paged_decode_attention(pool, i, q[:, 0].contiguous(), kv_length=kv_length)
        x = _finish(x, attn[:, None], blk, cfg)
    pool.advance(1)
    return _logits(params, x[:, 0]), pool


@torch.no_grad()
def prefill_with_kv(params, tokens, positions, cfg: GPT2Config):
    """Engine-adapter prefill: tokens, positions [B, S] -> (logits [B, S, V]
    fp32, per-layer (k, v) [B, S, H, D]).  Attention is K4, causal."""
    x = _embed(params, tokens, positions)
    kvs = []
    for blk in params["blocks"]:
        q, k, v = _qkv(x, blk, cfg)
        kvs.append((k, v))
        attn = flash_attention(q, k, v, causal=True, softmax_mode=cfg.softmax_mode)
        x = _finish(x, attn, blk, cfg)
    return _logits(params, x), kvs


@torch.no_grad()
def prefill_packed(params, tokens, positions, segment_ids, cfg: GPT2Config):
    """Packed multi-prompt prefill: several prompts in one [1, T] row,
    ``positions`` restarting at 0 a prompt and ``segment_ids`` 1, 2, ... a
    prompt (0 padding); K4 with both masks (no causal flag).  Returns
    (logits [1, T, V] fp32, per-layer (k, v) [1, T, H, D])."""
    x = _embed(params, tokens, positions)
    kvs = []
    for blk in params["blocks"]:
        q, k, v = _qkv(x, blk, cfg)
        kvs.append((k, v))
        attn = flash_attention(q, k, v, q_segment_ids=segment_ids, kv_segment_ids=segment_ids,
                               q_positions=positions, kv_positions=positions,
                               softmax_mode=cfg.softmax_mode)
        x = _finish(x, attn, blk, cfg)
    return _logits(params, x), kvs


def make_adapter(cfg: GPT2Config, *, eos_token=None):
    """Engine adapter: one-prompt, chunked and packed prefill, the batched
    decode step, the speculative verify step and the paged decode step.
    It has no ``prefill_suffix_paged``, as in JAX, so the paged engine
    takes no prefix cache."""
    from flash_attn_tpu_torch.engine.engine import ModelAdapter

    return ModelAdapter(
        prefill_with_kv=lambda p, t, pos: prefill_with_kv(p, t, pos, cfg),
        decode_step=lambda p, tok, cache: decode_step(p, tok, cfg, cache),
        decode_multi=lambda p, toks, cache: decode_multi(p, toks, cfg, cache),
        prefill_chunk=lambda p, t, cache, slot, start: prefill_chunk(
            p, t, cfg, cache, slot, start),
        decode_step_paged=lambda p, tok, pool: decode_step_paged(p, tok, cfg, pool),
        prefill_packed=lambda p, t, pos, seg: prefill_packed(p, t, pos, seg, cfg),
        num_layers=cfg.num_layers,
        num_kv_heads=cfg.num_heads,
        head_dim=cfg.head_dim,
        eos_token=eos_token,
    )


def make_cache(cfg: GPT2Config, batch, capacity, mode="none", dtype=None,
               device=None) -> KVCache:
    return KVCache.create(
        cfg.num_layers, batch, capacity, cfg.num_heads, cfg.head_dim,
        dtype=dtype or cfg.torch_dtype, mode=mode, device=device,
    )


@torch.no_grad()
def greedy_decode(params, prompt, cfg: GPT2Config, *, steps, kv_mode="none",
                  capacity=None):
    """Greedy generation: prompt [B, S0] -> tokens [B, steps]."""
    b, s0 = prompt.shape
    cache = make_cache(cfg, b, capacity or (s0 + steps), mode=kv_mode, device=prompt.device)
    logits, cache = prefill(params, prompt, cfg, cache)
    tok = logits.argmax(dim=-1)
    outs = [tok]
    for _ in range(steps - 1):
        logits, cache = decode_step(params, tok, cfg, cache)
        tok = logits.argmax(dim=-1)
        outs.append(tok)
    return torch.stack(outs, dim=1)


def load_hf(model_name: str = "gpt2", dtype="float32", device=None):
    """A HuggingFace GPT-2 checkpoint (``transformers``, which downloads
    it) as (params, cfg)."""
    from transformers import GPT2LMHeadModel

    model = GPT2LMHeadModel.from_pretrained(model_name)
    sd = {k: v.detach() for k, v in model.state_dict().items()}
    del model
    return convert_hf_state_dict(sd, dtype=dtype, device=device)


def convert_hf_state_dict(sd: dict, dtype="float32", num_heads=None, device=None):
    """A HF ``GPT2LMHeadModel`` state dict (numpy or torch values) ->
    (params, cfg).  HF stores its Conv1D weights as [in, out], the dense
    layers' orientation here, so nothing is transposed.  ``num_heads``:
    the state dict does not record it; the GPT-2 family's sizes are known
    by hidden, others default to heads of 64."""
    dev = resolve_device(device)
    dt = _DTYPES[dtype]

    def arr(name):
        return torch.as_tensor(sd[name]).to(device=dev, dtype=dt)

    vocab, hidden = sd["transformer.wte.weight"].shape
    n_layer = len({k.split(".")[2] for k in sd if k.startswith("transformer.h.")})
    cfg = GPT2Config(
        vocab_size=vocab,
        max_position=sd["transformer.wpe.weight"].shape[0],
        num_layers=n_layer,
        num_heads=num_heads or {768: 12, 1024: 16, 1280: 20, 1600: 25}.get(
            hidden, max(hidden // 64, 1)),
        hidden=hidden,
        dtype=dtype,
    )

    def dense(name):
        return {"w": arr(name + ".weight"), "b": arr(name + ".bias")}

    def ln(name):
        return {"g": arr(name + ".weight"), "b": arr(name + ".bias")}

    blocks = []
    for i in range(n_layer):
        p = f"transformer.h.{i}."
        blocks.append({
            "ln_1": ln(p + "ln_1"),
            "attn": {"qkv": dense(p + "attn.c_attn"), "proj": dense(p + "attn.c_proj")},
            "ln_2": ln(p + "ln_2"),
            "mlp": {"fc": dense(p + "mlp.c_fc"), "proj": dense(p + "mlp.c_proj")},
        })
    params = {"wte": arr("transformer.wte.weight"), "wpe": arr("transformer.wpe.weight"),
              "blocks": blocks, "ln_f": ln("transformer.ln_f")}
    return params, cfg
