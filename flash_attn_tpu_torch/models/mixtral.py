"""Mixtral in PyTorch: the Llama attention stack (RMSNorm + RoPE + GQA,
K4 prefill, K1 + K2 decode, K1c verify, K8 paged decode) with a top-k
routed mixture-of-experts FFN in every block, its projections on K3 (int8)
or the port's other quantized GEMMs.

Port of flash_attn_tpu/models/mixtral.py: the configs, ``init_params``
(from a ``torch.Generator``, quantizing each projection as it is drawn),
``_moe_mlp``, ``forward`` (differentiable, for training), ``prefill_with_kv``,
``prefill_packed``, ``decode_step``, ``decode_multi``,
``decode_step_paged``, ``make_cache``, ``make_adapter``,
``stack_experts``, ``quantize_weights`` and ``convert_hf_model``.  The
attention and the head are ``models/llama.py``'s paths, run with
``_moe_mlp`` as the layer's MLP; the sliding window is honored on every
serving path, as Llama's paths honor it (``prefill_with_kv``,
``prefill_packed``, ``decode_step``, ``decode_multi``,
``decode_step_paged``), and by ``forward`` except with ``segment_ids``.

Params per block: attn_norm, wq/wk/wv/wo, mlp_norm, router [H, E] and
experts, a list of {w_gate, w_up, w_down} dicts (any weight kind of
``ops/matmul.quantized_matmul``); top level tok_emb, final_norm, lm_head.
Router, embeddings and head stay float; the head runs in fp32 from the
copy ``llama.f32_head`` keeps.

The MoE is JAX's exact, capacity-less form: every expert runs for every
token and its output, weighted by the router (zero outside a token's top
k), is added in fp32 in expert order.  A decode step therefore reads
every expert's weights: 3 x E projections a layer.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from flash_attn_tpu_torch._device import resolve_device
from flash_attn_tpu_torch.engine.kv_cache import KVCache
from flash_attn_tpu_torch.models import llama
from flash_attn_tpu_torch.models.llama import _proj, _quant, _rms_norm
from flash_attn_tpu_torch.parallel.moe import router_topk

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
_EXPERT_NAMES = ("w_gate", "w_up", "w_down")


@dataclass(frozen=True)
class MixtralConfig:
    vocab_size: int = 32000
    hidden: int = 4096
    intermediate: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    num_experts: int = 8
    top_k: int = 2
    rope_theta: float = 1e6
    rms_eps: float = 1e-5
    max_position: int = 32768
    dtype: str = "bfloat16"
    # Mistral-style sliding window: the last ``sliding_window`` positions,
    # self included.  None = global.
    sliding_window: int | None = None

    # what Llama's paths read and Mixtral never sets (not fields)
    attn_logit_softcap = None
    tie_embeddings = False

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]


MIXTRAL_8X7B = MixtralConfig()
MIXTRAL_TINY = MixtralConfig(
    vocab_size=512, hidden=64, intermediate=128, num_layers=2,
    num_heads=4, num_kv_heads=2, head_dim=16, num_experts=4, top_k=2,
    max_position=256, rope_theta=10000.0, dtype="float32",
)


def init_params(cfg: MixtralConfig, seed: int = 0, *, device=None,
                quantize: str | None = None, group_size: int = 128) -> dict:
    """Random weights (normal * 0.02, the router * 0.1, norms 1) from
    ``seed`` on ``device`` (default: the card).  ``quantize`` (any mode of
    ``quantize_weights``) quantizes each attention and expert projection
    as soon as it is drawn, so no float expert stack ever exists: at
    8x7B the bf16 model (~87 GiB) does not fit the card, int8 (~43 GiB)
    does.  Equal to ``quantize_weights(init_params(...), quantize,
    group_size)``."""
    if quantize not in (None, *llama._MODES):
        raise ValueError(f"unknown quantization mode {quantize!r}")
    dev = resolve_device(device)
    dtype = cfg.torch_dtype
    gen = torch.Generator(device=dev).manual_seed(seed)

    def w(kin, kout, scale=0.02, quantized=True):
        t = torch.randn((kin, kout), generator=gen, device=dev, dtype=dtype) * scale
        return _quant(t, quantize, group_size) if quantize and quantized else t

    def ones():
        return torch.ones(cfg.hidden, dtype=dtype, device=dev)

    q_dim = cfg.num_heads * cfg.head_dim
    kv_dim = cfg.num_kv_heads * cfg.head_dim
    blocks = []
    for _ in range(cfg.num_layers):
        blk = {"attn_norm": ones(), "wq": w(cfg.hidden, q_dim), "wk": w(cfg.hidden, kv_dim),
               "wv": w(cfg.hidden, kv_dim), "wo": w(q_dim, cfg.hidden), "mlp_norm": ones(),
               "router": w(cfg.hidden, cfg.num_experts, scale=0.1, quantized=False)}
        blk["experts"] = [
            {"w_gate": w(cfg.hidden, cfg.intermediate), "w_up": w(cfg.hidden, cfg.intermediate),
             "w_down": w(cfg.intermediate, cfg.hidden)}
            for _ in range(cfg.num_experts)]
        blocks.append(blk)
    return {
        "tok_emb": w(cfg.vocab_size, cfg.hidden, quantized=False),
        "blocks": blocks,
        "final_norm": ones(),
        "lm_head": w(cfg.hidden, cfg.vocab_size, quantized=False),
    }


def quantize_weights(params: dict, mode: str = "int8", group_size: int = 128) -> dict:
    """Weight-only quantization of the attention and expert projections in
    ``mode`` (int8, int4, w8a8, w4a8, as ``llama.quantize_weights``); the
    router, embeddings and head stay float (routers are tiny and
    precision-critical).  Returns a new dict that shares the rest."""
    if mode not in llama._MODES:
        raise ValueError(f"unknown quantization mode {mode!r}")
    out = {k: v for k, v in params.items() if k != "_lm_head_f32"}
    out["blocks"] = []
    for blk in params["blocks"]:
        nb = dict(blk)
        for name in ("wq", "wk", "wv", "wo"):
            nb[name] = _quant(blk[name], mode, group_size)
        nb["experts"] = [{name: _quant(ex[name], mode, group_size) for name in _EXPERT_NAMES}
                         for ex in blk["experts"]]
        out["blocks"].append(nb)
    return out


def stack_experts(blk):
    """A block's float experts as (router, w_gate [E, H, F], w_up [E, H, F],
    w_down [E, F, H]), the layout of ``parallel/moe.moe_ffn_reference``.
    Quantized experts must be stacked before quantization."""
    return (blk["router"],) + tuple(
        torch.stack([ex[name] for ex in blk["experts"]]) for name in _EXPERT_NAMES)


def _moe_mlp(x, blk, cfg: MixtralConfig):
    """x [..., H] -> x + the routed experts' sum.  The router runs in fp32
    (a plain matmul, outside any kernel, as in JAX); every expert runs for
    every token through ``quantized_matmul`` and its output, weighted by
    the token's top-k softmax (zero elsewhere), is added in fp32 in expert
    order.  Differentiable in float weights: the gradient reaches the
    router's top-k logits and every expert, as ``jax.grad`` of JAX's."""
    h = _rms_norm(x, blk["mlp_norm"], cfg.rms_eps)
    hs = h.reshape(-1, cfg.hidden)
    combine = router_topk(hs.float() @ blk["router"].float(), cfg.top_k)  # [T, E]
    out = torch.zeros((hs.shape[0], cfg.hidden), dtype=torch.float32, device=x.device)
    for e, ex in enumerate(blk["experts"]):
        gate = _proj(hs, ex["w_gate"])
        up = _proj(hs, ex["w_up"])
        act = torch.nn.functional.silu(gate.float()) * up.float()
        oe = _proj(act.to(hs.dtype), ex["w_down"])
        out = out + combine[:, e:e + 1] * oe.float()
    return x + out.to(x.dtype).reshape(x.shape)


def forward(params, tokens, cfg: MixtralConfig, *, positions=None, segment_ids=None,
            remat: bool = False):
    """tokens [B, S] -> logits [B, S, V] fp32 (causal, online softmax, the
    window), differentiable w.r.t. every float param: ``llama.forward``
    with ``_moe_mlp`` as each block's MLP, so the gradient reaches the
    router through ``router_topk`` and every expert.  ``remat``
    checkpoints each block; ``positions`` and ``segment_ids`` (packed
    documents, also with the window) as Llama's."""
    return llama.forward(params, tokens, cfg, positions=positions, segment_ids=segment_ids,
                         remat=remat, mlp=_moe_mlp)


@torch.no_grad()
def prefill_with_kv(params, tokens, positions, cfg: MixtralConfig):
    """Engine-adapter prefill (``llama.prefill_with_kv``): logits [B, S, V]
    fp32 and the per-layer rotated (k, v)."""
    return llama.prefill_with_kv(params, tokens, positions, cfg, mlp=_moe_mlp)


@torch.no_grad()
def prefill_packed(params, tokens, positions, segment_ids, cfg: MixtralConfig):
    """Packed multi-prompt prefill (``llama.prefill_packed``)."""
    return llama.prefill_packed(params, tokens, positions, segment_ids, cfg, mlp=_moe_mlp)


@torch.no_grad()
def decode_step(params, token, cfg: MixtralConfig, cache: KVCache):
    """One cached decode step (``llama.decode_step``), the window on K1."""
    return llama.decode_step(params, token, cfg, cache, mlp=_moe_mlp)


@torch.no_grad()
def decode_multi(params, tokens, cfg: MixtralConfig, cache: KVCache):
    """The speculative verify step (``llama.decode_multi``): the MoE runs on
    the [B, T] chunk."""
    return llama.decode_multi(params, tokens, cfg, cache, mlp=_moe_mlp)


@torch.no_grad()
def decode_step_paged(params, token, cfg: MixtralConfig, pool):
    """One decode step against a paged pool (``llama.decode_step_paged``)."""
    return llama.decode_step_paged(params, token, cfg, pool, mlp=_moe_mlp)


def make_cache(cfg: MixtralConfig, batch, capacity, mode="none", dtype=None,
               device=None) -> KVCache:
    return llama.make_cache(cfg, batch, capacity, mode=mode, dtype=dtype, device=device)


def make_adapter(cfg: MixtralConfig, *, eos_token=None):
    """Engine adapter, as JAX's: one-prompt and packed prefill, the decode
    step, the verify step and the paged decode step.  No chunked prefill
    and no suffix prefill, so the paged engine serves Mixtral without
    prefix caching."""
    from flash_attn_tpu_torch.engine.engine import ModelAdapter

    return ModelAdapter(
        prefill_with_kv=lambda p, t, pos: prefill_with_kv(p, t, pos, cfg),
        decode_step=lambda p, tok, cache: decode_step(p, tok, cfg, cache),
        prefill_packed=lambda p, t, pos, seg: prefill_packed(p, t, pos, seg, cfg),
        decode_multi=lambda p, toks, cache: decode_multi(p, toks, cfg, cache),
        decode_step_paged=lambda p, tok, pool: decode_step_paged(p, tok, cfg, pool),
        num_layers=cfg.num_layers,
        num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim,
        eos_token=eos_token,
    )


def convert_hf_model(model, dtype="bfloat16", device=None):
    """A torch HF ``MixtralForCausalLM`` (its config and state dict) ->
    (params, MixtralConfig) on ``device`` (default: the card), as
    flash_attn_tpu/models/mixtral.py:convert_hf_model maps it.  HF routes
    by a softmax over all experts renormalized over the top k, which
    equals the softmax over the top-k logits.  Imports no
    ``transformers``."""
    hf, _, arr = llama._hf_reader(model, dtype, device)
    cfg = MixtralConfig(
        vocab_size=hf.vocab_size,
        hidden=hf.hidden_size,
        intermediate=hf.intermediate_size,
        num_layers=hf.num_hidden_layers,
        num_heads=hf.num_attention_heads,
        num_kv_heads=hf.num_key_value_heads,
        head_dim=hf.hidden_size // hf.num_attention_heads,
        num_experts=hf.num_local_experts,
        top_k=hf.num_experts_per_tok,
        rope_theta=float(getattr(hf, "rope_theta", 1e6)),
        rms_eps=float(hf.rms_norm_eps),
        max_position=hf.max_position_embeddings,
        dtype=dtype,
    )
    blocks = []
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        m = p + "block_sparse_moe."
        blocks.append({
            "attn_norm": arr(p + "input_layernorm.weight", transpose=False),
            "wq": arr(p + "self_attn.q_proj.weight"),
            "wk": arr(p + "self_attn.k_proj.weight"),
            "wv": arr(p + "self_attn.v_proj.weight"),
            "wo": arr(p + "self_attn.o_proj.weight"),
            "mlp_norm": arr(p + "post_attention_layernorm.weight", transpose=False),
            "router": arr(m + "gate.weight"),
            "experts": [{"w_gate": arr(m + f"experts.{e}.w1.weight"),
                         "w_up": arr(m + f"experts.{e}.w3.weight"),
                         "w_down": arr(m + f"experts.{e}.w2.weight")}
                        for e in range(cfg.num_experts)],
        })
    params = {
        "tok_emb": arr("model.embed_tokens.weight", transpose=False),
        "blocks": blocks,
        "final_norm": arr("model.norm.weight", transpose=False),
        "lm_head": arr("lm_head.weight"),
    }
    return params, cfg


def load_hf(model_name: str, dtype="bfloat16", device=None):
    """Download a HF Mixtral checkpoint and convert it
    (``convert_hf_model``).  Needs ``transformers`` and the network."""
    from transformers import AutoModelForCausalLM

    model = AutoModelForCausalLM.from_pretrained(
        model_name, torch_dtype=torch.float32, low_cpu_mem_usage=True)
    return convert_hf_model(model, dtype=dtype, device=device)
