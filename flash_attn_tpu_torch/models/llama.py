"""Llama-3 in PyTorch: RMSNorm + RoPE + GQA + SwiGLU over the port's
kernels (prefill K4, also with positions (chunked) and segment ids
(packed), decode K1 + K2, the speculative verify step K1c,
paged decode K8, the paged suffix prefill K8c (K1c and K8c: one chunk
kernel),
projections and quantized heads K3, K5, K6, K7; the training forward's
attention K4 with its backward K9 + K10).

Port of flash_attn_tpu/models/llama.py for the serving and training
paths: the configs (Llama-3 8B and 70B, Qwen-2-7B), ``init_params``
(from a ``torch.Generator``), ``quantize_weights`` (int8, int4, w8a8,
w4a8, with a separate ``head_mode``), ``fuse_projections``, ``forward``
(training), ``prefill_with_kv``, ``prefill_chunk``, ``prefill_packed``,
``decode_step``, ``decode_multi``, ``decode_step_paged``,
``prefill_suffix_paged``, ``make_cache``, ``make_adapter`` and
``convert_hf_model`` (a HF Llama-family model: Llama, Qwen-2).
Params are a plain dict like the JAX pytree: per block wq/wk/wv (or the
fused wqkv), wo, w_gate/w_up (or w_gate_up), w_down, attn_norm/mlp_norm;
top level tok_emb, final_norm, lm_head.  A weight is any kind that
``ops/matmul.quantized_matmul`` takes; with ``qkv_bias`` (Qwen-2) wq, wk
and wv are ``BiasedWeight``s whose bias stays float.

``sliding_window`` and ``attn_logit_softcap`` are honored where the
kernels take them: ``forward`` and ``prefill_with_kv`` (K4, and K9 + K10
in the backward) and ``decode_step`` (K1 in decode mode).  The packed,
chunked, verify and paged paths raise ``NotImplementedError`` on either
before any launch: their kernels (K4 with masks, K1c, K8, K8c) take
neither.

The serving paths also take ``mlp``, the layer's MLP (default the SwiGLU
``_block_mlp``): ``models/mixtral.py`` runs them with its routed experts.

``prefill_with_kv`` and ``decode_step`` take a LoRA tree or stacked bank
(``models/lora.py``: ``lora`` with ``lora_id``, or ``lora_ids`` [B] a
slot), as JAX's do: each adapted projection adds its delta after the base
matmul (and after a ``BiasedWeight``'s bias), on the split outputs of
``wqkv`` and ``w_gate_up``.  LoRA takes the dense MLP only (JAX's Mixtral
has none).

The LM head takes fp32 activations as in the JAX model.  A float head
runs as an fp32 matmul: the first call that needs it stores an fp32 copy
in the params dict under ``"_lm_head_f32"`` (about 2.1 GB at the 8B
shape) beside the head tensor and its version counter, so no step
converts it and a head changed in place (a training step) is copied
anew.  A quantized head (``head_mode``) is used as it is.  The training
``forward`` keeps no such copy: its fp32 head is made from the bf16 one
at each call, so it follows the optimizer's updates and passes the
gradient back to ``lm_head``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.utils.checkpoint import checkpoint

from flash_attn_tpu_torch._device import resolve_device
from flash_attn_tpu_torch.engine.kv_cache import KVCache
from flash_attn_tpu_torch.engine.paged import PagedKVPool, paged_decode_attention
from flash_attn_tpu_torch.models.lora import lora_delta
from flash_attn_tpu_torch.ops.attention import flash_attention
from flash_attn_tpu_torch.ops.decode import flash_decode, flash_decode_chunk
from flash_attn_tpu_torch.ops.matmul import (
    BiasedWeight,
    W4A8Weight,
    W8A8Weight,
    concat_weights,
    quantized_matmul,
)
from flash_attn_tpu_torch.ops.paged_decode import paged_flash_decode_chunk
from flash_attn_tpu_torch.ops.quant import quantize_int4, quantize_int8
from flash_attn_tpu_torch.ops.rope import rope_cos_sin, rope_rotate

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
_PROJ_NAMES = ("wq", "wk", "wv", "wqkv", "wo", "w_gate", "w_up",
               "w_gate_up", "w_down")
_MODES = ("int8", "int4", "w8a8", "w4a8")


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
    # Mistral-style sliding window (the last ``sliding_window`` positions,
    # self included; None = global) and Gemma-2-style logit softcap
    # (cap * tanh(s / cap); None = off): see the module docstring for the
    # paths that honor them
    sliding_window: int | None = None
    attn_logit_softcap: float | None = None
    # Qwen-2's bias on the q/k/v projections (wq/wk/wv become BiasedWeight)
    qkv_bias: bool = False

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]


LLAMA3_8B = LlamaConfig()
LLAMA3_70B = LlamaConfig(
    hidden=8192, intermediate=28672, num_layers=80, num_heads=64, num_kv_heads=8
)
QWEN2_7B = LlamaConfig(
    vocab_size=152064, hidden=3584, intermediate=18944, num_layers=28,
    num_heads=28, num_kv_heads=4, head_dim=128, rope_theta=1000000.0,
    rms_eps=1e-6, max_position=32768, qkv_bias=True,
)
LLAMA_TINY = LlamaConfig(
    vocab_size=512, hidden=128, intermediate=256, num_layers=2,
    num_heads=4, num_kv_heads=2, head_dim=32, max_position=256,
    rope_theta=10000.0, dtype="float32",
)


def _quant(w, mode: str, group_size: int = 128):
    """One weight in one quantization mode (flash_attn_tpu/models/llama.py:
    quantize_weights.quant)."""
    if isinstance(w, BiasedWeight):
        return BiasedWeight(_quant(w.w, mode, group_size), w.bias)
    if mode in ("int8", "w8a8"):
        vals, scale = quantize_int8(w, dims=(0,))
        vals, scale = vals.contiguous(), scale[0].contiguous()
        return (vals, scale) if mode == "int8" else W8A8Weight(vals, scale)
    if mode == "int4":
        return quantize_int4(w, group_size=group_size)
    if mode == "w4a8":
        q4 = quantize_int4(w, group_size=group_size)
        return W4A8Weight(q4.packed, q4.scales, q4.group_size, q4.shape)
    raise ValueError(f"unknown quantization mode {mode!r}")


def _fuse_block(blk: dict) -> dict:
    """wq/wk/wv -> wqkv and w_gate/w_up -> w_gate_up (idempotent)."""
    if "wqkv" in blk:
        return blk
    nb = {k: v for k, v in blk.items()
          if k not in ("wq", "wk", "wv", "w_gate", "w_up")}
    nb["wqkv"] = concat_weights([blk["wq"], blk["wk"], blk["wv"]])
    nb["w_gate_up"] = concat_weights([blk["w_gate"], blk["w_up"]])
    return nb


def init_params(cfg: LlamaConfig, seed: int = 0, *, device=None,
                quantize: str | None = None, group_size: int = 128,
                head_mode: str | None = None, fuse: bool = False) -> dict:
    """Random weights (normal * 0.02, norms 1) from ``seed`` on ``device``
    (default: the card).  ``quantize`` (any mode of ``quantize_weights``)
    quantizes each block's projections as soon as they are made, and
    ``fuse`` fuses them right after, so neither a float model nor an
    unfused copy ever exists (at 70B that is the difference between ~42
    and ~170 GB).  ``head_mode`` quantizes the LM head as it is made;
    without it the head stays float.  Equal to ``fuse_projections(
    quantize_weights(init_params(...), quantize, group_size,
    skip=("tok_emb",) if head_mode else ("tok_emb", "lm_head"),
    head_mode=head_mode))``."""
    if quantize not in (None, *_MODES) or head_mode not in (None, *_MODES):
        raise ValueError(f"unknown quantization mode {quantize!r} / {head_mode!r}")
    dev = resolve_device(device)
    dtype = cfg.torch_dtype
    gen = torch.Generator(device=dev).manual_seed(seed)

    def w(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype) * 0.02

    q_dim = cfg.num_heads * cfg.head_dim
    kv_dim = cfg.num_kv_heads * cfg.head_dim
    blocks = []
    for _ in range(cfg.num_layers):
        blk = {"attn_norm": torch.ones(cfg.hidden, dtype=dtype, device=dev)}
        # one projection at a time: quantized before the next is drawn; a
        # qkv bias is drawn right after its weight
        for name, kin, kout in (
                ("wq", cfg.hidden, q_dim), ("wk", cfg.hidden, kv_dim),
                ("wv", cfg.hidden, kv_dim), ("wo", q_dim, cfg.hidden)):
            blk[name] = w(kin, kout)
            if cfg.qkv_bias and name != "wo":
                blk[name] = BiasedWeight(blk[name], w(kout))
            if quantize:
                blk[name] = _quant(blk[name], quantize, group_size)
        blk["mlp_norm"] = torch.ones(cfg.hidden, dtype=dtype, device=dev)
        for name, kin, kout in (
                ("w_gate", cfg.hidden, cfg.intermediate),
                ("w_up", cfg.hidden, cfg.intermediate),
                ("w_down", cfg.intermediate, cfg.hidden)):
            blk[name] = w(kin, kout)
            if quantize:
                blk[name] = _quant(blk[name], quantize, group_size)
        blocks.append(_fuse_block(blk) if fuse else blk)
    tok_emb = w(cfg.vocab_size, cfg.hidden)
    lm_head = w(cfg.hidden, cfg.vocab_size)
    if head_mode:
        lm_head = _quant(lm_head, head_mode, group_size)
    return {
        "tok_emb": tok_emb,
        "blocks": blocks,
        "final_norm": torch.ones(cfg.hidden, dtype=dtype, device=dev),
        "lm_head": lm_head,
    }


def quantize_weights(params: dict, mode: str = "int8", group_size: int = 128,
                     skip=("tok_emb", "lm_head"),
                     head_mode: str | None = None) -> dict:
    """Quantize every projection (fused names too) in ``mode``: 'int8'
    (per-column scales), 'int4' (group-``group_size`` Int4Weight), 'w8a8'
    or 'w4a8' (the same weights, with per-token int8 activations).  The
    embeddings and head stay float unless 'lm_head' is left out of
    ``skip``; ``head_mode`` then overrides ``mode`` for the head.  Returns
    a new dict that shares the unquantized tensors."""
    out = {k: v for k, v in params.items() if k != "_lm_head_f32"}
    out["blocks"] = []
    for blk in params["blocks"]:
        nb = dict(blk)
        for name in _PROJ_NAMES:
            if name in nb:
                nb[name] = _quant(blk[name], mode, group_size)
        out["blocks"].append(nb)
    if "lm_head" not in skip and not isinstance(params["lm_head"], tuple):
        out["lm_head"] = _quant(params["lm_head"], head_mode or mode, group_size)
    return out


def fuse_projections(params: dict) -> dict:
    """Fuse wq/wk/wv -> wqkv and w_gate/w_up -> w_gate_up in every block,
    before or after quantization (``ops/matmul.concat_weights``).  Returns
    a new dict; at 70B prefer ``init_params(fuse=True)``, which never
    holds both copies."""
    out = dict(params)
    out["blocks"] = [_fuse_block(blk) for blk in params["blocks"]]
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


def _lora_add(y, x, lblk, name, ids, scaling):
    """``y`` (the projection of ``x`` by ``name``) plus its LoRA delta
    when ``lblk`` adapts ``name`` (flash_attn_tpu/models/llama.py:
    _proj_l): after the bias of a ``BiasedWeight``, on the split output
    of a fused weight."""
    if lblk is None or name not in lblk:
        return y
    return y + lora_delta(x, lblk[name], ids, scaling).to(y.dtype)


def _block_mlp(x, blk, cfg, lblk=None, lora_ids=None, lora_scaling=1.0):
    h = _rms_norm(x, blk["mlp_norm"], cfg.rms_eps)
    if "w_gate_up" in blk:
        y = _proj(h, blk["w_gate_up"])
        gate, up = y[..., :cfg.intermediate], y[..., cfg.intermediate:]
    else:
        gate = _proj(h, blk["w_gate"])
        up = _proj(h, blk["w_up"])
    gate = _lora_add(gate, h, lblk, "w_gate", lora_ids, lora_scaling)
    up = _lora_add(up, h, lblk, "w_up", lora_ids, lora_scaling)
    act = (torch.nn.functional.silu(gate.float()) * up.float()).to(x.dtype)
    return x + _lora_add(_proj(act, blk["w_down"]), act, lblk, "w_down", lora_ids,
                         lora_scaling)


def _logits(params, x, cfg):
    """LM head on the fp32 final-normed hidden state: a float head as an
    fp32 matmul, a quantized one through its kernel.  The fp32 copy is
    kept with the tensor it was made from and that tensor's version, and
    made anew once either changes (an optimizer step updates the head in
    place)."""
    src = params["tok_emb"] if cfg.tie_embeddings else params["lm_head"]
    if not isinstance(src, torch.Tensor):
        return _proj(x.float(), src)
    return _proj(x.float(), f32_head(params, src, cfg.tie_embeddings))


def f32_head(params, src, tied: bool):
    """The fp32 [hidden, vocab] copy of a float head ``src`` (the
    embedding transposed when ``tied``), kept in ``params`` under
    ``"_lm_head_f32"`` with ``src`` and its version, made anew once either
    changes."""
    cached = params.get("_lm_head_f32")
    if cached is None or cached[0] is not src or cached[1] != src._version:
        w = src.T if tied else src
        cached = (src, src._version, w.float().contiguous())
        params["_lm_head_f32"] = cached
    return cached[2]


def _qkv(h, blk, cfg, b, s, lblk=None, ids=None, lsc=1.0):
    """q, k, v [b, s, heads, D] from one fused ``wqkv`` matmul or three;
    LoRA deltas (``lblk``, per name) go on the split outputs."""
    q_dim = cfg.num_heads * cfg.head_dim
    kv_dim = cfg.num_kv_heads * cfg.head_dim
    if "wqkv" in blk:
        y = _proj(h, blk["wqkv"])
        q, k, v = y[..., :q_dim], y[..., q_dim:q_dim + kv_dim], y[..., q_dim + kv_dim:]
    else:
        q, k, v = _proj(h, blk["wq"]), _proj(h, blk["wk"]), _proj(h, blk["wv"])
    q = _lora_add(q, h, lblk, "wq", ids, lsc)
    k = _lora_add(k, h, lblk, "wk", ids, lsc)
    v = _lora_add(v, h, lblk, "wv", ids, lsc)
    return (q.reshape(b, s, cfg.num_heads, cfg.head_dim),
            k.reshape(b, s, cfg.num_kv_heads, cfg.head_dim),
            v.reshape(b, s, cfg.num_kv_heads, cfg.head_dim))


def _wnd(cfg):
    """K4's (left, right) window for ``cfg.sliding_window``, or None."""
    return None if cfg.sliding_window is None else (cfg.sliding_window - 1, -1)


def _refuse_local(cfg, path: str):
    """Raise before any launch when ``path``'s kernels cannot honor the
    window or the softcap (``ROADMAP.md`` queue B item 3)."""
    for name in ("sliding_window", "attn_logit_softcap"):
        if getattr(cfg, name) is not None:
            raise NotImplementedError(f"{path} with {name} is not ported yet")


def _block_train(x, blk, cfg, cos, sin, mlp, segment_ids=None):
    """One layer of the training forward: causal attention with q rotated
    inside the kernel (online softmax), within each document where
    ``segment_ids`` are given, then the MLP."""
    b, s, _ = x.shape
    h = _rms_norm(x, blk["attn_norm"], cfg.rms_eps)
    q, k, v = _qkv(h, blk, cfg, b, s)
    k = rope_rotate(k, cos, sin)
    attn = flash_attention(q.contiguous(), k, v.contiguous(), causal=True,
                           window=_wnd(cfg), logit_softcap=cfg.attn_logit_softcap,
                           q_segment_ids=segment_ids, kv_segment_ids=segment_ids,
                           rope_cos=cos, rope_sin=sin)
    x = x + _proj(attn.reshape(b, s, cfg.num_heads * cfg.head_dim), blk["wo"])
    return mlp(x, blk, cfg)


def forward(params, tokens, cfg: LlamaConfig, *, positions=None,
            segment_ids=None, remat: bool = False, mlp=_block_mlp):
    """tokens [B, S] -> logits [B, S, V] fp32 (training, causal), and
    differentiable w.r.t. every float param.  ``remat`` checkpoints each
    block (``torch.utils.checkpoint``): the backward reruns its forward,
    K4 included.  ``jax.checkpoint`` of the whole forward, as the JAX
    train step does it, gives the same values.  ``segment_ids`` [B, S]
    (packed documents, with ``positions`` restarting a document for RoPE)
    keep each query to its own document's keys, causal within it, as JAX's
    ``_block_attn`` does: K4 with segment ids forward, K9 and K10 with
    them backward."""
    if segment_ids is not None:
        _refuse_local(cfg, "forward with segment_ids")
    b, s = tokens.shape
    if positions is None:
        positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
    x = params["tok_emb"][tokens]
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    for blk in params["blocks"]:
        if remat:
            x = checkpoint(_block_train, x, blk, cfg, cos, sin, mlp, segment_ids,
                           use_reentrant=False)
        else:
            x = _block_train(x, blk, cfg, cos, sin, mlp, segment_ids)
    x = _rms_norm(x, params["final_norm"], cfg.rms_eps)
    head = params["tok_emb"].T if cfg.tie_embeddings else params["lm_head"]
    return _proj(x.float(), head)


def _check_lora(lora, mlp):
    """LoRA adapts the dense SwiGLU layer only (JAX's Mixtral takes none)."""
    if lora is not None and mlp is not _block_mlp:
        raise ValueError("LoRA needs the dense MLP (_block_mlp); a custom mlp takes none")


def _lora_layer(lora, i):
    """(block i's LoRA entries or None, scaling)."""
    if lora is None:
        return None, 1.0
    return lora["blocks"][i], lora["scaling"]


def prefill_with_kv(params, tokens, positions, cfg: LlamaConfig, *, mlp=_block_mlp,
                    lora=None, lora_id=None):
    """tokens, positions [B, S] -> (logits [B, S, V] fp32, per-layer list
    of rotated (k, v) [B, S, Hk, D]).  Attention is K4, causal and clamped,
    with q rotated inside the kernel, the window and the softcap.

    lora: optional LoRA tree or stacked bank (models/lora.py); with a
    bank, ``lora_id`` (an int) selects the adapter of this prefill."""
    _check_lora(lora, mlp)
    b, s = tokens.shape
    x = params["tok_emb"][tokens]
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    kvs = []
    for i, blk in enumerate(params["blocks"]):
        lblk, lsc = _lora_layer(lora, i)
        h = _rms_norm(x, blk["attn_norm"], cfg.rms_eps)
        q, k, v = _qkv(h, blk, cfg, b, s, lblk, lora_id, lsc)
        k = rope_rotate(k, cos, sin)
        kvs.append((k, v))
        attn = flash_attention(q.contiguous(), k, v.contiguous(), causal=True,
                               window=_wnd(cfg), logit_softcap=cfg.attn_logit_softcap,
                               rope_cos=cos, rope_sin=sin, softmax_mode="clamped")
        a = attn.reshape(b, s, cfg.num_heads * cfg.head_dim)
        x = x + _lora_add(_proj(a, blk["wo"]), a, lblk, "wo", lora_id, lsc)
        x = mlp(x, blk, cfg) if lblk is None else _block_mlp(x, blk, cfg, lblk, lora_id, lsc)
    x = _rms_norm(x, params["final_norm"], cfg.rms_eps)
    return _logits(params, x, cfg), kvs


def prefill_chunk(params, tokens, cfg: LlamaConfig, cache: KVCache, slot: int,
                  start: int):
    """Chunked prefill: tokens [1, C] at positions [start, start + C) of
    ``slot``.  Per layer the chunk's K/V is written into the cache at
    ``start`` (``insert_at``), then its queries attend to the slot's whole
    dequantized cache through K4 with positions (q at start + i, the cache
    at its index; no causal flag), clamped, q rotated in the kernel: K4
    skips the key tiles past the chunk, so the cache is not sliced.
    Returns (logits [1, C, V] fp32, cache), the cache updated in place."""
    _refuse_local(cfg, "prefill_chunk")
    b, c = tokens.shape
    dev = tokens.device
    x = params["tok_emb"][tokens]
    qpos = (start + torch.arange(c, device=dev))[None]
    kvpos = torch.arange(cache.capacity, device=dev)[None]
    cos, sin = rope_cos_sin(qpos, cfg.head_dim, cfg.rope_theta)
    for i, blk in enumerate(params["blocks"]):
        h = _rms_norm(x, blk["attn_norm"], cfg.rms_eps)
        q, k, v = _qkv(h, blk, cfg, b, c)
        k = rope_rotate(k, cos, sin)  # the cache stores rotated K
        cache.insert_at(i, slot, k[0], v[0], start)
        kc, vc = cache.slot_kv_float(i, slot, dtype=x.dtype)
        attn = flash_attention(q.contiguous(), kc, vc, q_positions=qpos,
                               kv_positions=kvpos, rope_cos=cos, rope_sin=sin,
                               softmax_mode="clamped")
        x = x + _proj(attn.reshape(b, c, cfg.num_heads * cfg.head_dim), blk["wo"])
        x = _block_mlp(x, blk, cfg)
    x = _rms_norm(x, params["final_norm"], cfg.rms_eps)
    return _logits(params, x, cfg), cache


def prefill_packed(params, tokens, positions, segment_ids, cfg: LlamaConfig, *,
                   mlp=_block_mlp):
    """Packed multi-prompt prefill: several prompts concatenated in one
    [1, T] row, ``positions`` restarting at 0 a prompt (RoPE's positions
    too) and ``segment_ids`` 1, 2, ... a prompt (0 padding).  Attention is
    K4 with segment ids and positions (per-prompt causality; no causal
    flag), clamped, q rotated in the kernel.  Returns (logits [1, T, V]
    fp32, per-layer list of rotated (k, v) [1, T, Hk, D])."""
    _refuse_local(cfg, "prefill_packed")
    b, t = tokens.shape
    x = params["tok_emb"][tokens]
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    kvs = []
    for blk in params["blocks"]:
        h = _rms_norm(x, blk["attn_norm"], cfg.rms_eps)
        q, k, v = _qkv(h, blk, cfg, b, t)
        k = rope_rotate(k, cos, sin)
        kvs.append((k, v))
        attn = flash_attention(q.contiguous(), k, v.contiguous(),
                               q_segment_ids=segment_ids, kv_segment_ids=segment_ids,
                               q_positions=positions, kv_positions=positions,
                               rope_cos=cos, rope_sin=sin, softmax_mode="clamped")
        x = x + _proj(attn.reshape(b, t, cfg.num_heads * cfg.head_dim), blk["wo"])
        x = mlp(x, blk, cfg)
    x = _rms_norm(x, params["final_norm"], cfg.rms_eps)
    return _logits(params, x, cfg), kvs


def decode_step(params, token, cfg: LlamaConfig, cache: KVCache, *, mlp=_block_mlp,
                lora=None, lora_ids=None):
    """One cached decode step for every slot: token [B] -> (logits [B, V]
    fp32, cache).  The cache is updated in place (K2 appends each layer's
    K/V at ``length``, then ``length`` advances by one); K1 attends with
    the window and the softcap.

    lora: optional LoRA tree or stacked bank (models/lora.py); with a
    bank, ``lora_ids`` [B] selects each slot's adapter (multi-adapter
    serving)."""
    _check_lora(lora, mlp)
    kv_length = cache.length + 1

    def attend(q, kc, vc, ks, vs):
        return flash_decode(q, kc, vc, k_scale=ks, v_scale=vs, kv_length=kv_length,
                            kv_layout="bhsd", window=cfg.sliding_window,
                            logit_softcap=cfg.attn_logit_softcap)

    return _decode_layers(params, token, cfg, cache, attend, mlp, lora, lora_ids)


def decode_step_sharded(params, token, cfg: LlamaConfig, cache: KVCache, mesh, *,
                        axis_name: str = "sp"):
    """``decode_step`` with the cache's capacity axis sharded over the
    mesh's ``axis_name`` (BASELINE configs 3-4): per layer K2 appends into
    the whole buffer, each rank runs K1 on its run of the capacity (a view
    of the one buffer, read in place) with its own lengths
    (``shard_lengths``, on the device), and one K1m launch merges every
    shard's splits (``parallel/sharded_decode.py``).  No length is read
    back to the host, so the step captures as ``decode_step`` does.
    Raises ``NotImplementedError`` when the axis's ranks are not all on
    the cache's device, ``ValueError`` when the capacity does not divide
    by them; both before any launch."""
    from flash_attn_tpu_torch.parallel.sharded_decode import (
        check_kv_mesh,
        make_sharded_decode,
        shard_lengths,
    )

    n = check_kv_mesh(mesh, axis_name, cache.capacity, cache.length.device)
    _refuse_local(cfg, "decode_step_sharded")
    dec = make_sharded_decode(mesh, axis_name=axis_name, quantized=cache.mode != "none",
                              kv_layout="bhsd")
    lens = shard_lengths(cache.length + 1, n, cache.capacity // n)

    def attend(q, kc, vc, ks, vs):
        return dec(q, kc, vc, ks, vs, lens) if ks is not None else dec(q, kc, vc, lens)

    return _decode_layers(params, token, cfg, cache, attend, _block_mlp, None, None)


def _decode_layers(params, token, cfg, cache, attend, mlp, lora, lora_ids):
    """The decode step's layers around ``attend(q [B, H, D], k, v, k_scale,
    v_scale)``, the attention over the cache's layer after its append."""
    b = token.shape[0]
    x = params["tok_emb"][token][:, None, :]  # [B, 1, hidden]
    cos, sin = rope_cos_sin(cache.length[:, None], cfg.head_dim, cfg.rope_theta)
    for i, blk in enumerate(params["blocks"]):
        lblk, lsc = _lora_layer(lora, i)
        h = _rms_norm(x, blk["attn_norm"], cfg.rms_eps)
        q, k, v = _qkv(h, blk, cfg, b, 1, lblk, lora_ids, lsc)
        q = rope_rotate(q, cos, sin)
        k = rope_rotate(k, cos, sin)
        cache.append(i, k, v)
        attn = attend(q[:, 0], *cache.layer(i))
        a = attn.reshape(b, 1, cfg.num_heads * cfg.head_dim)
        x = x + _lora_add(_proj(a, blk["wo"]), a, lblk, "wo", lora_ids, lsc)
        x = mlp(x, blk, cfg) if lblk is None else _block_mlp(x, blk, cfg, lblk, lora_ids, lsc)
    cache.advance(1)
    x = _rms_norm(x[:, 0], params["final_norm"], cfg.rms_eps)
    return _logits(params, x, cfg), cache


def decode_multi(params, tokens, cfg: LlamaConfig, cache: KVCache, *, mlp=_block_mlp):
    """T cached decode tokens per sequence in one pass, the speculative
    verify step: tokens [B, T] -> (logits [B, T, V] fp32, cache).  Per
    layer the chunk's K/V is appended at ``length`` first, then its T
    queries attend to the cache through K1c, the chunk kernel (one cache
    sweep, causal within the chunk); ``length`` advances by T after the
    last layer.  The cache is updated in place."""
    _refuse_local(cfg, "decode_multi")
    b, t = tokens.shape
    x = params["tok_emb"][tokens]  # [B, T, hidden]
    pos = cache.length[:, None] + torch.arange(t, device=tokens.device)[None]
    cos, sin = rope_cos_sin(pos, cfg.head_dim, cfg.rope_theta)
    kv_length = cache.length + t
    for i, blk in enumerate(params["blocks"]):
        h = _rms_norm(x, blk["attn_norm"], cfg.rms_eps)
        q, k, v = _qkv(h, blk, cfg, b, t)
        q = rope_rotate(q, cos, sin)
        k = rope_rotate(k, cos, sin)
        cache.append(i, k, v)
        kc, vc, ks, vs = cache.layer(i)
        attn = flash_decode_chunk(q, kc, vc, k_scale=ks, v_scale=vs,
                                  kv_length=kv_length, kv_layout="bhsd")
        x = x + _proj(attn.reshape(b, t, cfg.num_heads * cfg.head_dim), blk["wo"])
        x = mlp(x, blk, cfg)
    cache.advance(t)
    x = _rms_norm(x, params["final_norm"], cfg.rms_eps)
    return _logits(params, x, cfg), cache


def decode_step_paged(params, token, cfg: LlamaConfig, pool: PagedKVPool, *,
                      mlp=_block_mlp):
    """One decode step for every slot against a paged pool: token [B] ->
    (logits [B, V] fp32, pool).  Per layer the token's K/V is appended at
    ``length``, then attention (K8, decode mode) sees ``length + 1``
    positions; ``length`` advances once after the last layer.  The pool
    is updated in place."""
    _refuse_local(cfg, "decode_step_paged")
    b = token.shape[0]
    x = params["tok_emb"][token][:, None, :]
    cos, sin = rope_cos_sin(pool.length[:, None], cfg.head_dim, cfg.rope_theta)
    kv_length = pool.length + 1
    for i, blk in enumerate(params["blocks"]):
        h = _rms_norm(x, blk["attn_norm"], cfg.rms_eps)
        q, k, v = _qkv(h, blk, cfg, b, 1)
        q = rope_rotate(q, cos, sin)
        k = rope_rotate(k, cos, sin)
        pool.append_token(i, k[:, 0], v[:, 0])
        attn = paged_decode_attention(pool, i, q[:, 0].contiguous(),
                                      kv_length=kv_length)
        x = x + _proj(attn.reshape(b, 1, cfg.num_heads * cfg.head_dim), blk["wo"])
        x = mlp(x, blk, cfg)
    pool.advance(1)
    x = _rms_norm(x[:, 0], params["final_norm"], cfg.rms_eps)
    return _logits(params, x, cfg), pool


def prefill_suffix_paged(params, tokens, cfg: LlamaConfig, pool: PagedKVPool,
                         slot: int, start: int, sub_chunk: int = 128):
    """Prefix-cache suffix prefill: tokens [1, C] at positions [start,
    start + C) of ``slot``, whose positions [0, start) are already in its
    pages.  Each ``sub_chunk``-token piece goes through every layer before
    the next: per layer its K/V is appended to the pool, then its queries
    attend to the slot's pages through K8c, the chunk kernel, so the prefix
    KV streams from its pages and is never recomputed.  The pieces set M in
    every projection, as in the JAX model.  Returns (logits [1, C, V]
    fp32, pool)."""
    _refuse_local(cfg, "prefill_suffix_paged")
    b, c = tokens.shape
    table = pool.block_table[slot:slot + 1]
    parts = []
    for off in range(0, c, sub_chunk):
        cc = min(sub_chunk, c - off)
        start_cc = start + off
        x = params["tok_emb"][tokens[:, off:off + cc]]
        qpos = (start_cc + torch.arange(cc, device=tokens.device))[None]
        cos, sin = rope_cos_sin(qpos, cfg.head_dim, cfg.rope_theta)
        # includes this piece
        kv_len = torch.full((1,), start_cc + cc, dtype=torch.int32, device=tokens.device)
        for i, blk in enumerate(params["blocks"]):
            h = _rms_norm(x, blk["attn_norm"], cfg.rms_eps)
            q, k, v = _qkv(h, blk, cfg, b, cc)
            q = rope_rotate(q, cos, sin)
            k = rope_rotate(k, cos, sin)
            pool.append_prefill(i, slot, k[0], v[0], start_cc)
            attn = paged_flash_decode_chunk(
                q, pool.k_pages[i], pool.v_pages[i], table, kv_len,
                k_scale=None if pool.k_scale is None else pool.k_scale[i],
                v_scale=None if pool.v_scale is None else pool.v_scale[i])
            x = x + _proj(attn.reshape(b, cc, cfg.num_heads * cfg.head_dim), blk["wo"])
            x = _block_mlp(x, blk, cfg)
        x = _rms_norm(x, params["final_norm"], cfg.rms_eps)
        parts.append(_logits(params, x, cfg))
    return torch.cat(parts, dim=1), pool


def make_cache(cfg: LlamaConfig, batch, capacity, mode="none", dtype=None,
               device=None) -> KVCache:
    return KVCache.create(
        cfg.num_layers, batch, capacity, cfg.num_kv_heads, cfg.head_dim,
        dtype=dtype or cfg.torch_dtype, mode=mode, device=device,
    )


def make_adapter(cfg: LlamaConfig, *, eos_token=None, mesh=None, kv_shard_axis: str = "sp"):
    """Engine adapter: one-prompt, chunked and packed prefill, the batched
    decode step, the speculative verify step, the paged counterparts
    (decode step, prefix-cache suffix prefill), and the LoRA prefill and
    decode step over a stacked bank (``InferenceEngine(lora_bank=...)``).
    With ``mesh`` the decode step is ``decode_step_sharded`` over
    ``kv_shard_axis``: pass the same mesh to ``InferenceEngine``."""
    from flash_attn_tpu_torch.engine.engine import ModelAdapter

    if mesh is not None:
        def dec(p, tok, cache):
            return decode_step_sharded(p, tok, cfg, cache, mesh, axis_name=kv_shard_axis)
    else:
        def dec(p, tok, cache):
            return decode_step(p, tok, cfg, cache)

    return ModelAdapter(
        prefill_with_kv=lambda p, t, pos: prefill_with_kv(p, t, pos, cfg),
        decode_step=dec,
        decode_multi=lambda p, toks, cache: decode_multi(p, toks, cfg, cache),
        prefill_chunk=lambda p, t, cache, slot, start: prefill_chunk(
            p, t, cfg, cache, slot, start),
        prefill_packed=lambda p, t, pos, seg: prefill_packed(p, t, pos, seg, cfg),
        decode_step_paged=lambda p, tok, pool: decode_step_paged(p, tok, cfg, pool),
        prefill_suffix_paged=lambda p, t, pool, slot, start: prefill_suffix_paged(
            p, t, cfg, pool, slot, start),
        prefill_with_kv_lora=lambda p, t, pos, bank, aid: prefill_with_kv(
            p, t, pos, cfg, lora=bank, lora_id=aid),
        decode_step_lora=lambda p, tok, cache, bank, ids: decode_step(
            p, tok, cfg, cache, lora=bank, lora_ids=ids),
        num_layers=cfg.num_layers,
        num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim,
        eos_token=eos_token,
    )


def _hf_reader(model, dtype: str, device):
    """(HF config, state-dict names, getter) for a torch HF model: the
    getter returns the named entry as ``dtype`` on ``device``, transposed
    ([out, in] -> [in, out]) unless ``transpose`` is false."""
    sd = model.state_dict()
    dev = resolve_device(device)
    dt = _DTYPES[dtype]

    def arr(name, transpose=True):
        t = sd[name].detach().to(device=dev, dtype=dt)
        return (t.T if transpose else t).contiguous()

    return model.config, set(sd), arr


def convert_hf_model(model, dtype="bfloat16", device=None):
    """A torch HF ``LlamaForCausalLM`` or ``Qwen2ForCausalLM`` (its config
    and state dict) -> (params, LlamaConfig) on ``device`` (default: the
    card), as flash_attn_tpu/models/llama.py:convert_hf_model maps it:
    ``qkv_bias`` from the presence of q_proj's bias, and a tied head
    (``tie_word_embeddings``) as the embedding transposed.  Imports no
    ``transformers``: it reads the model it is given."""
    hf, names, arr = _hf_reader(model, dtype, device)
    cfg = LlamaConfig(
        vocab_size=hf.vocab_size,
        hidden=hf.hidden_size,
        intermediate=hf.intermediate_size,
        num_layers=hf.num_hidden_layers,
        num_heads=hf.num_attention_heads,
        num_kv_heads=hf.num_key_value_heads,
        head_dim=hf.hidden_size // hf.num_attention_heads,
        rope_theta=float(getattr(hf, "rope_theta", 500000.0)),
        rms_eps=float(hf.rms_norm_eps),
        max_position=hf.max_position_embeddings,
        dtype=dtype,
        tie_embeddings=bool(getattr(hf, "tie_word_embeddings", False)),
        qkv_bias="model.layers.0.self_attn.q_proj.bias" in names,
    )

    def proj(name):
        w = arr(name + ".weight")
        if cfg.qkv_bias and name + ".bias" in names:
            return BiasedWeight(w, arr(name + ".bias", transpose=False))
        return w

    blocks = []
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        blocks.append({
            "attn_norm": arr(p + "input_layernorm.weight", transpose=False),
            "wq": proj(p + "self_attn.q_proj"),
            "wk": proj(p + "self_attn.k_proj"),
            "wv": proj(p + "self_attn.v_proj"),
            "wo": arr(p + "self_attn.o_proj.weight"),
            "mlp_norm": arr(p + "post_attention_layernorm.weight", transpose=False),
            "w_gate": arr(p + "mlp.gate_proj.weight"),
            "w_up": arr(p + "mlp.up_proj.weight"),
            "w_down": arr(p + "mlp.down_proj.weight"),
        })
    emb = arr("model.embed_tokens.weight", transpose=False)
    params = {
        "tok_emb": emb,
        "blocks": blocks,
        "final_norm": arr("model.norm.weight", transpose=False),
        "lm_head": emb.T if cfg.tie_embeddings else arr("lm_head.weight"),
    }
    return params, cfg


def load_hf(model_name: str, dtype="bfloat16", device=None):
    """Download a HF Llama-family checkpoint and convert it
    (``convert_hf_model``).  Needs ``transformers`` and the network."""
    from transformers import AutoModelForCausalLM

    model = AutoModelForCausalLM.from_pretrained(
        model_name, torch_dtype=torch.float32, low_cpu_mem_usage=True)
    return convert_hf_model(model, dtype=dtype, device=device)
