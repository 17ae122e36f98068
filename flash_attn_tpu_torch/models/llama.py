"""Llama-3 in PyTorch: RMSNorm + RoPE + GQA + SwiGLU over the port's
kernels (prefill K4, decode K1 + K2, projections K3).

Port of flash_attn_tpu/models/llama.py for the serving path: the config,
``init_params`` (from a ``torch.Generator``), ``quantize_weights``
(int8), ``prefill_with_kv``, ``decode_step``, ``make_cache`` and
``make_adapter``.  Params are a plain dict like the JAX pytree: per block
wq/wk/wv/wo, w_gate/w_up/w_down (float tensors or ``(int8, scales)``
tuples), attn_norm/mlp_norm; top level tok_emb, final_norm, lm_head.

The LM head runs in fp32 as in the JAX model; the first call that needs
it stores an fp32 copy of the head in the params dict under
``"_lm_head_f32"`` (about 2.1 GB at the 8B shape), so no step converts it.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from flash_attn_tpu_torch._device import resolve_device
from flash_attn_tpu_torch.engine.kv_cache import KVCache
from flash_attn_tpu_torch.ops.attention import flash_attention
from flash_attn_tpu_torch.ops.decode import flash_decode
from flash_attn_tpu_torch.ops.matmul import quantized_matmul
from flash_attn_tpu_torch.ops.quant import quantize_int8
from flash_attn_tpu_torch.ops.rope import rope_cos_sin, rope_rotate

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
_PROJ_NAMES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    hidden: int = 4096
    intermediate: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    rope_theta: float = 500000.0
    rms_eps: float = 1e-5
    max_position: int = 8192
    dtype: str = "bfloat16"
    tie_embeddings: bool = False

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]


LLAMA3_8B = LlamaConfig()
LLAMA_TINY = LlamaConfig(
    vocab_size=512, hidden=128, intermediate=256, num_layers=2,
    num_heads=4, num_kv_heads=2, head_dim=32, max_position=256,
    rope_theta=10000.0, dtype="float32",
)


def _quant_int8(w: torch.Tensor):
    vals, scale = quantize_int8(w, dims=(0,))
    return vals.contiguous(), scale[0].contiguous()


def init_params(cfg: LlamaConfig, seed: int = 0, *, device=None,
                quantize: str | None = None) -> dict:
    """Random weights (normal * 0.02, norms 1) from ``seed`` on ``device``
    (default: the card).  quantize='int8' quantizes each block's
    projections as soon as they are made, so the float copy of the whole
    model never exists (peak memory stays near the int8 size)."""
    if quantize not in (None, "int8"):
        raise NotImplementedError(f"quantize={quantize!r} is not ported yet")
    dev = resolve_device(device)
    dtype = cfg.torch_dtype
    gen = torch.Generator(device=dev).manual_seed(seed)

    def w(kin, kout):
        return torch.randn((kin, kout), generator=gen, device=dev,
                           dtype=dtype) * 0.02

    q_dim = cfg.num_heads * cfg.head_dim
    kv_dim = cfg.num_kv_heads * cfg.head_dim
    blocks = []
    for _ in range(cfg.num_layers):
        blk = {
            "attn_norm": torch.ones(cfg.hidden, dtype=dtype, device=dev),
            "wq": w(cfg.hidden, q_dim),
            "wk": w(cfg.hidden, kv_dim),
            "wv": w(cfg.hidden, kv_dim),
            "wo": w(q_dim, cfg.hidden),
            "mlp_norm": torch.ones(cfg.hidden, dtype=dtype, device=dev),
            "w_gate": w(cfg.hidden, cfg.intermediate),
            "w_up": w(cfg.hidden, cfg.intermediate),
            "w_down": w(cfg.intermediate, cfg.hidden),
        }
        if quantize == "int8":
            for name in _PROJ_NAMES:
                blk[name] = _quant_int8(blk[name])
        blocks.append(blk)
    return {
        "tok_emb": w(cfg.vocab_size, cfg.hidden),
        "blocks": blocks,
        "final_norm": torch.ones(cfg.hidden, dtype=dtype, device=dev),
        "lm_head": w(cfg.hidden, cfg.vocab_size),
    }


def quantize_weights(params: dict, mode: str = "int8",
                     skip=("tok_emb", "lm_head")) -> dict:
    """Weight-only int8 quantization of every projection (per-column
    scales); embeddings and head stay float by default.  Returns a new
    dict that shares the unquantized tensors."""
    if mode != "int8":
        raise NotImplementedError(f"mode {mode!r} is not ported yet")
    out = {k: v for k, v in params.items() if k != "_lm_head_f32"}
    out["blocks"] = []
    for blk in params["blocks"]:
        nb = dict(blk)
        for name in _PROJ_NAMES:
            if name in nb and not isinstance(nb[name], tuple):
                nb[name] = _quant_int8(nb[name])
        out["blocks"].append(nb)
    if "lm_head" not in skip and not isinstance(params["lm_head"], tuple):
        out["lm_head"] = _quant_int8(params["lm_head"])
    return out


def _rms_norm(x, g, eps):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * g.float()).to(x.dtype)


def _proj(x, w):
    """[..., K] x (quantized or float) [K, N] -> [..., N]."""
    lead = x.shape[:-1]
    out = quantized_matmul(x.reshape(-1, x.shape[-1]).contiguous(), w)
    return out.reshape(*lead, out.shape[-1])


def _block_mlp(x, blk, cfg):
    h = _rms_norm(x, blk["mlp_norm"], cfg.rms_eps)
    gate = _proj(h, blk["w_gate"])
    up = _proj(h, blk["w_up"])
    act = torch.nn.functional.silu(gate.float()) * up.float()
    return x + _proj(act.to(x.dtype), blk["w_down"])


def _logits(params, x, cfg):
    """fp32 LM head on the final-normed hidden state."""
    head = params.get("_lm_head_f32")
    if head is None:
        w = params["tok_emb"].T if cfg.tie_embeddings else params["lm_head"]
        if isinstance(w, tuple):
            raise NotImplementedError("a quantized LM head is not ported yet")
        head = w.float().contiguous()
        params["_lm_head_f32"] = head
    return _proj(x.float(), head)


def _qkv(h, blk, cfg, b, s):
    q = _proj(h, blk["wq"]).reshape(b, s, cfg.num_heads, cfg.head_dim)
    k = _proj(h, blk["wk"]).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    v = _proj(h, blk["wv"]).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    return q, k, v


def prefill_with_kv(params, tokens, positions, cfg: LlamaConfig):
    """tokens, positions [B, S] -> (logits [B, S, V] fp32, per-layer list
    of rotated (k, v) [B, S, Hk, D]).  Attention is K4, causal and clamped,
    with q rotated inside the kernel."""
    b, s = tokens.shape
    x = params["tok_emb"][tokens]
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    kvs = []
    for blk in params["blocks"]:
        h = _rms_norm(x, blk["attn_norm"], cfg.rms_eps)
        q, k, v = _qkv(h, blk, cfg, b, s)
        k = rope_rotate(k, cos, sin)
        kvs.append((k, v))
        attn = flash_attention(q.contiguous(), k, v.contiguous(), causal=True,
                               rope_cos=cos, rope_sin=sin,
                               softmax_mode="clamped")
        x = x + _proj(attn.reshape(b, s, cfg.num_heads * cfg.head_dim),
                      blk["wo"])
        x = _block_mlp(x, blk, cfg)
    x = _rms_norm(x, params["final_norm"], cfg.rms_eps)
    return _logits(params, x, cfg), kvs


def decode_step(params, token, cfg: LlamaConfig, cache: KVCache):
    """One cached decode step for every slot: token [B] -> (logits [B, V]
    fp32, cache).  The cache is updated in place (K2 appends each layer's
    K/V at ``length``, then ``length`` advances by one)."""
    b = token.shape[0]
    x = params["tok_emb"][token][:, None, :]  # [B, 1, hidden]
    cos, sin = rope_cos_sin(cache.length[:, None], cfg.head_dim, cfg.rope_theta)
    kv_length = cache.length + 1
    for i, blk in enumerate(params["blocks"]):
        h = _rms_norm(x, blk["attn_norm"], cfg.rms_eps)
        q, k, v = _qkv(h, blk, cfg, b, 1)
        q = rope_rotate(q, cos, sin)
        k = rope_rotate(k, cos, sin)
        cache.append(i, k, v)
        kc, vc, ks, vs = cache.layer(i)
        attn = flash_decode(q[:, 0], kc, vc, k_scale=ks, v_scale=vs,
                            kv_length=kv_length, kv_layout="bhsd")
        x = x + _proj(attn.reshape(b, 1, cfg.num_heads * cfg.head_dim),
                      blk["wo"])
        x = _block_mlp(x, blk, cfg)
    cache.advance(1)
    x = _rms_norm(x[:, 0], params["final_norm"], cfg.rms_eps)
    return _logits(params, x, cfg), cache


def make_cache(cfg: LlamaConfig, batch, capacity, mode="none", dtype=None,
               device=None) -> KVCache:
    return KVCache.create(
        cfg.num_layers, batch, capacity, cfg.num_kv_heads, cfg.head_dim,
        dtype=dtype or cfg.torch_dtype, mode=mode, device=device,
    )


def make_adapter(cfg: LlamaConfig, *, eos_token=None):
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
