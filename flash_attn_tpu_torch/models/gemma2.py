"""Gemma-2 in PyTorch for serving and training: sandwich RMSNorms with a
(1 + g) gain, GeGLU MLPs, GQA with head_dim 256 at 9B, the attention logit
softcap, sliding-window attention on the even layers,
``query_pre_attn_scalar`` and a tied, softcapped fp32 head, over the
port's kernels (prefill and the training forward K4 with window and
softcap, its backward K9 + K10 with both, decode K1 with window and
softcap + K2, the projections K3 and the other quantized GEMMs).

Port of flash_attn_tpu/models/gemma2.py: the configs, ``init_params``
(from a ``torch.Generator``), ``quantize_weights``, ``forward`` (the
training forward, differentiable, with per-block checkpointing),
``prefill_with_kv``, ``decode_step``, ``make_cache``, ``make_adapter``
and ``convert_hf_state_dict``.  Conventions follow HF
``Gemma2ForCausalLM``, as the JAX module's do:

- RMSNorm multiplies by ``(1 + weight)`` in fp32 before the downcast;
- ``x + post_norm(attn(pre_norm(x)))``, and the same around the MLP;
- embeddings scaled by sqrt(hidden) rounded to the embedding dtype; the
  head is the embedding, transposed, in fp32 (serving keeps the copy in
  the params dict under ``"_lm_head_f32"``, 3.67 GB at 9B, as
  ``models/llama.py`` keeps its head's; the training forward reads the
  embedding itself, so it takes both gradients);
- attention scale ``query_pre_attn_scalar ** -0.5``, attention logits
  capped at ``attn_logit_softcap``, final logits at
  ``final_logit_softcap``;
- even layers (0, 2, ...) attend to the last ``sliding_window`` tokens,
  self included; odd layers are global.

The adapter has no ``prefill_packed``, ``prefill_chunk`` or
``decode_multi``, as in JAX: the engine prefills one prompt a call.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.utils.checkpoint import checkpoint

from flash_attn_tpu_torch._device import resolve_device
from flash_attn_tpu_torch.engine.kv_cache import KVCache
from flash_attn_tpu_torch.models import llama
from flash_attn_tpu_torch.models.llama import _proj, _qkv
from flash_attn_tpu_torch.ops.attention import flash_attention
from flash_attn_tpu_torch.ops.decode import flash_decode
from flash_attn_tpu_torch.ops.rope import rope_cos_sin, rope_rotate

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclass(frozen=True)
class Gemma2Config:
    vocab_size: int = 256128
    hidden: int = 3584
    intermediate: int = 14336
    num_layers: int = 42
    num_heads: int = 16
    num_kv_heads: int = 8
    head_dim: int = 256
    rope_theta: float = 10000.0
    rms_eps: float = 1e-6
    max_position: int = 8192
    dtype: str = "bfloat16"
    sliding_window: int = 4096
    query_pre_attn_scalar: float = 256.0
    attn_logit_softcap: float = 50.0
    final_logit_softcap: float = 30.0

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]


GEMMA2_9B = Gemma2Config()
GEMMA2_27B = Gemma2Config(
    hidden=4608, intermediate=36864, num_layers=46, num_heads=32,
    num_kv_heads=16, head_dim=128, query_pre_attn_scalar=144.0,
)
GEMMA2_TINY = Gemma2Config(
    vocab_size=512, hidden=64, intermediate=128, num_layers=2,
    num_heads=4, num_kv_heads=2, head_dim=16, max_position=128,
    sliding_window=16, query_pre_attn_scalar=16.0, dtype="float32",
)


def _is_sliding(layer_idx: int) -> bool:
    """HF Gemma2 layer_types: even layers sliding, odd layers global."""
    return layer_idx % 2 == 0


def _wnd(cfg: Gemma2Config, layer_idx: int):
    """(left, right) window for flash_attention, or None (global layer)."""
    if not _is_sliding(layer_idx):
        return None
    return (cfg.sliding_window - 1, -1)


def _dec_wnd(cfg: Gemma2Config, layer_idx: int):
    """window for flash_decode (token count), or None."""
    return cfg.sliding_window if _is_sliding(layer_idx) else None


def init_params(cfg: Gemma2Config, seed: int = 0, *, device=None,
                quantize: str | None = None, group_size: int = 128) -> dict:
    """Random weights (normal * 0.02, norms 0: a gain of 1) from ``seed``
    on ``device`` (default: the card).  ``quantize`` (any mode of
    ``llama.quantize_weights``) quantizes each projection as soon as it is
    made, so the float model never exists whole (at 9B: ~10 GB int8
    against ~18 GB bf16).  ``tok_emb`` (the tied head) stays float."""
    dev = resolve_device(device)
    dtype = cfg.torch_dtype
    gen = torch.Generator(device=dev).manual_seed(seed)

    def w(kin, kout):
        return torch.randn((kin, kout), generator=gen, device=dev, dtype=dtype) * 0.02

    def zeros():
        return torch.zeros(cfg.hidden, dtype=dtype, device=dev)

    q_dim = cfg.num_heads * cfg.head_dim
    kv_dim = cfg.num_kv_heads * cfg.head_dim
    blocks = []
    for _ in range(cfg.num_layers):
        blk = {"attn_norm": zeros(), "post_attn_norm": zeros(),
               "pre_mlp_norm": zeros(), "post_mlp_norm": zeros()}
        for name, kin, kout in (
                ("wq", cfg.hidden, q_dim), ("wk", cfg.hidden, kv_dim),
                ("wv", cfg.hidden, kv_dim), ("wo", q_dim, cfg.hidden),
                ("w_gate", cfg.hidden, cfg.intermediate),
                ("w_up", cfg.hidden, cfg.intermediate),
                ("w_down", cfg.intermediate, cfg.hidden)):
            blk[name] = w(kin, kout)
            if quantize:
                blk[name] = llama._quant(blk[name], quantize, group_size)
        blocks.append(blk)
    return {"tok_emb": w(cfg.vocab_size, cfg.hidden), "blocks": blocks,
            "final_norm": zeros()}


def quantize_weights(params: dict, mode: str = "int8", group_size: int = 128) -> dict:
    """Weight-only quantization of every projection, as
    ``llama.quantize_weights``; ``tok_emb`` (the tied head) stays float."""
    return llama.quantize_weights(params, mode=mode, group_size=group_size)


def _rms_norm(x, g, eps):
    """Gemma RMSNorm: fp32 normalize, multiply by (1 + g) in fp32, then
    downcast (HF Gemma2RMSNorm's op order)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + g.float())).to(x.dtype)


def _embed(params, tokens, cfg):
    # HF multiplies embeddings by sqrt(hidden) cast to the embedding dtype;
    # a Python float (exact in fp32), so a captured step copies nothing
    normalizer = float(torch.tensor(cfg.hidden ** 0.5, dtype=cfg.torch_dtype))
    x = params["tok_emb"][tokens]
    return (x.float() * normalizer).to(x.dtype)


def _final_logits(params, x, cfg, train: bool):
    """The final norm, then the tied head in fp32 and the final softcap.
    Serving (``train`` false) uses the cached fp32 head and caps in place;
    training's head is the live embedding and its cap is out of place,
    which autograd can differentiate."""
    x = _rms_norm(x, params["final_norm"], cfg.rms_eps)
    cap = cfg.final_logit_softcap
    if train:
        logits = _proj(x.float(), params["tok_emb"].T)
        return logits if cap is None else cap * torch.tanh(logits / cap)
    logits = _proj(x.float(), llama.f32_head(params, params["tok_emb"], True))
    if cap is not None:
        # in place: a prefill's fp32 logits are 8.4 GB at [1, 8192, 256128]
        logits.div_(cap).tanh_().mul_(cap)
    return logits


def _block_mlp(x, blk, cfg):
    h = _rms_norm(x, blk["pre_mlp_norm"], cfg.rms_eps)
    gate, up = _proj(h, blk["w_gate"]), _proj(h, blk["w_up"])
    # GeGLU with the tanh-approximate gelu (HF gelu_pytorch_tanh)
    act = torch.nn.functional.gelu(gate.float(), approximate="tanh") * up.float()
    down = _proj(act.to(x.dtype), blk["w_down"])
    return x + _rms_norm(down, blk["post_mlp_norm"], cfg.rms_eps)


def _attn_out(x, attn, blk, cfg):
    """x + post_norm(attn @ wo) for attention out [B, S, H, D]."""
    b, s = attn.shape[:2]
    o = _proj(attn.reshape(b, s, cfg.num_heads * cfg.head_dim), blk["wo"])
    return x + _rms_norm(o, blk["post_attn_norm"], cfg.rms_eps)


def _layer(x, blk, cfg, window, cos, sin, softmax_mode):
    """One layer on K4 with its window and the softcap, q rotated in the
    kernel: (x, the layer's rotated k, v)."""
    b, s, _ = x.shape
    h = _rms_norm(x, blk["attn_norm"], cfg.rms_eps)
    q, k, v = _qkv(h, blk, cfg, b, s)
    k = rope_rotate(k, cos, sin)  # q rotates in the kernel
    v = v.contiguous()
    attn = flash_attention(q.contiguous(), k, v, causal=True,
                           scale=cfg.query_pre_attn_scalar ** -0.5, window=window,
                           logit_softcap=cfg.attn_logit_softcap, rope_cos=cos, rope_sin=sin,
                           softmax_mode=softmax_mode)
    x = _attn_out(x, attn, blk, cfg)
    return _block_mlp(x, blk, cfg), k, v


def _prefill(params, tokens, positions, cfg, softmax_mode, remat=False):
    """The layers over a prompt: (x [B, S, hidden], per-layer rotated
    (k, v)); ``remat`` checkpoints each layer."""
    x = _embed(params, tokens, cfg)
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    kvs = []
    for i, blk in enumerate(params["blocks"]):
        args = (x, blk, cfg, _wnd(cfg, i), cos, sin, softmax_mode)
        x, k, v = checkpoint(_layer, *args, use_reentrant=False) if remat else _layer(*args)
        kvs.append((k, v))
    return x, kvs


def forward(params, tokens, cfg: Gemma2Config, *, positions=None, remat: bool = False):
    """tokens [B, S] -> logits [B, S, V] fp32 (training, causal; final
    logits capped; online softmax), differentiable w.r.t. every float
    param; the tied embedding takes the gradients of both its uses.
    ``remat`` checkpoints each block (``torch.utils.checkpoint``): the
    backward reruns its forward, K4 included.  ``jax.checkpoint`` of the
    whole forward, as the JAX train step does it, gives the same values."""
    b, s = tokens.shape
    if positions is None:
        positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
    x, _ = _prefill(params, tokens, positions, cfg, "online", remat)
    return _final_logits(params, x, cfg, train=True)


@torch.no_grad()
def prefill_with_kv(params, tokens, positions, cfg: Gemma2Config):
    """Engine-adapter prefill: tokens, positions [B, S] -> (logits [B, S, V]
    fp32, per-layer rotated (k, v) [B, S, Hk, D]).  Attention is K4,
    causal and clamped (exact: the softcap keeps every score below 50 nats,
    under the clamp's 55)."""
    x, kvs = _prefill(params, tokens, positions, cfg, "clamped")
    return _final_logits(params, x, cfg, train=False), kvs


@torch.no_grad()
def decode_step(params, token, cfg: Gemma2Config, cache: KVCache):
    """One cached decode step for every slot: token [B] -> (logits [B, V]
    fp32, cache).  Per layer K2 appends the token's K/V at ``length``, then
    K1 attends with the layer's window and the softcap (online for fp8 KV:
    the cap reaches the fp8 clamped ceiling); ``length`` advances by one
    after the last layer.  The cache is updated in place."""
    b = token.shape[0]
    x = _embed(params, token[:, None], cfg)
    cos, sin = rope_cos_sin(cache.length[:, None], cfg.head_dim, cfg.rope_theta)
    scale = cfg.query_pre_attn_scalar ** -0.5
    kv_length = cache.length + 1
    for i, blk in enumerate(params["blocks"]):
        h = _rms_norm(x, blk["attn_norm"], cfg.rms_eps)
        q, k, v = _qkv(h, blk, cfg, b, 1)
        q = rope_rotate(q, cos, sin)
        k = rope_rotate(k, cos, sin)
        cache.append(i, k, v)
        kc, vc, ks, vs = cache.layer(i)
        attn = flash_decode(q[:, 0], kc, vc, k_scale=ks, v_scale=vs, kv_length=kv_length,
                            kv_layout="bhsd", scale=scale, window=_dec_wnd(cfg, i),
                            logit_softcap=cfg.attn_logit_softcap)
        x = _attn_out(x, attn[:, None], blk, cfg)
        x = _block_mlp(x, blk, cfg)
    cache.advance(1)
    return _final_logits(params, x[:, 0], cfg, train=False), cache


def make_cache(cfg: Gemma2Config, batch, capacity, mode="none", dtype=None,
               device=None) -> KVCache:
    return KVCache.create(
        cfg.num_layers, batch, capacity, cfg.num_kv_heads, cfg.head_dim,
        dtype=dtype or cfg.torch_dtype, mode=mode, device=device,
    )


def make_adapter(cfg: Gemma2Config, *, eos_token=None):
    """Engine adapter: one-prompt prefill and the batched decode step."""
    from flash_attn_tpu_torch.engine.engine import ModelAdapter

    return ModelAdapter(
        prefill_with_kv=lambda p, t, pos: prefill_with_kv(p, t, pos, cfg),
        decode_step=lambda p, tok, cache: decode_step(p, tok, cfg, cache),
        num_layers=cfg.num_layers,
        num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim,
        eos_token=eos_token,
    )


def convert_hf_state_dict(sd: dict, dtype="float32", device=None):
    """A HF ``Gemma2ForCausalLM`` state dict (numpy or torch values) ->
    (params, (vocab, hidden, num_layers, q_dim, kv_dim)).  Linear weights
    are [out, in] in torch and are transposed here; norm weights stay
    zero-centred (the (1 + w) gain is applied in ``_rms_norm``)."""
    dev = resolve_device(device)
    dt = _DTYPES[dtype]

    def g(name):
        return torch.as_tensor(sd[name]).to(device=dev, dtype=dt)

    def lin(name):
        return g(name).T.contiguous()

    emb = g("model.embed_tokens.weight")
    vocab, hidden = emb.shape
    num_layers = 0
    while f"model.layers.{num_layers}.self_attn.q_proj.weight" in sd:
        num_layers += 1
    blocks = []
    for i in range(num_layers):
        pre = f"model.layers.{i}."
        blocks.append({
            "attn_norm": g(pre + "input_layernorm.weight"),
            "post_attn_norm": g(pre + "post_attention_layernorm.weight"),
            "wq": lin(pre + "self_attn.q_proj.weight"),
            "wk": lin(pre + "self_attn.k_proj.weight"),
            "wv": lin(pre + "self_attn.v_proj.weight"),
            "wo": lin(pre + "self_attn.o_proj.weight"),
            "pre_mlp_norm": g(pre + "pre_feedforward_layernorm.weight"),
            "post_mlp_norm": g(pre + "post_feedforward_layernorm.weight"),
            "w_gate": lin(pre + "mlp.gate_proj.weight"),
            "w_up": lin(pre + "mlp.up_proj.weight"),
            "w_down": lin(pre + "mlp.down_proj.weight"),
        })
    params = {"tok_emb": emb, "blocks": blocks, "final_norm": g("model.norm.weight")}
    q_dim = sd["model.layers.0.self_attn.q_proj.weight"].shape[0]
    kv_dim = sd["model.layers.0.self_attn.k_proj.weight"].shape[0]
    return params, (vocab, hidden, num_layers, q_dim, kv_dim)
