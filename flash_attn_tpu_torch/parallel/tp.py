"""Tensor parallelism (Megatron-style) as sharded param leaves.

Port of flash_attn_tpu/parallel/tp.py.  In JAX tensor parallelism is
sharding annotations and the model code does not change; here it is the
leaf type ``ops/matmul.ShardedWeight`` (rank r's slice on its device),
which ``quantized_matmul``, GPT-2's dense layers, the embedding lookups
and the LM heads take, so ``forward``, ``prefill_with_kv``,
``decode_step`` and the engine run sharded params unchanged.

Column-parallel (qkv, gate, up, the head): the output axis is split and
the parts' outputs are gathered.  Row-parallel (attention out, MLP down):
the input axis is split and the parts' outputs summed in rank order (the
psum XLA places after the contraction).  The embeddings are split on the
vocabulary.  Replicated leaves stay single tensors on the axis's first
device: in the single-process form one process computes for every rank.
"""

from __future__ import annotations

from flash_attn_tpu_torch.ops.matmul import (
    BiasedWeight,
    ShardedWeight,
    W4A8Weight,
    W8A8Weight,
    _is_legacy_w8a8,
)
from flash_attn_tpu_torch.ops.quant import Int4Weight
from flash_attn_tpu_torch.parallel.mesh import TENSOR_AXIS, shard

# embedding tables split on the vocabulary (P(tp, None) on a lookup table)
_VOCAB = ("tok_emb", "wte")
# projection kinds in the Llama block tree (quantized or not)
_LLAMA_COL = ("wq", "wk", "wv", "w_gate", "w_up")
_LLAMA_ROW = ("wo", "w_down")


def llama_param_specs(tp_axis: str = TENSOR_AXIS) -> dict:
    """The spec tree of models/llama.py's params: one entry a dimension,
    None or the mesh axis it is split over; () replicated."""
    col, row, rep = (None, tp_axis), (tp_axis, None), ()
    block = {"attn_norm": rep, "mlp_norm": rep, "wq": col, "wk": col, "wv": col,
             "wo": row, "w_gate": col, "w_up": col, "w_down": row}
    return {"tok_emb": (tp_axis, None), "blocks": block, "final_norm": rep, "lm_head": col}


def gpt2_param_specs(tp_axis: str = TENSOR_AXIS) -> dict:
    """The spec tree of models/gpt2.py's params."""
    col, row, rep = (None, tp_axis), (tp_axis, None), ()
    dense_col = {"w": col, "b": (tp_axis,)}
    dense_row = {"w": row, "b": rep}
    ln = {"g": rep, "b": rep}
    block = {"ln_1": ln, "attn": {"qkv": dense_col, "proj": dense_row},
             "ln_2": ln, "mlp": {"fc": dense_col, "proj": dense_row}}
    return {"wte": (tp_axis, None), "wpe": rep, "blocks": block, "ln_f": ln}


def _axis(mesh, spec):
    named = [a for a in spec if a is not None]
    return named[0] if named else None


def _place(mesh, x, spec, key=None):
    """A float leaf split by ``spec``: a ShardedWeight, "col" on the last
    axis, "row" on the first, "vocab" for an embedding table."""
    if len(spec) != x.ndim:
        raise ValueError(f"spec {spec} does not fit a {x.ndim}-d leaf")
    if spec[-1] is not None:
        kind = "col"
    else:
        kind = "vocab" if key in _VOCAB else "row"
    return ShardedWeight(kind, shard(mesh, x, spec), mesh)


def _replicate(mesh, x, axis):
    return x.to(mesh.axis_devices(axis)[0])


def shard_params(params: dict, mesh, specs: dict) -> dict:
    """Apply a spec tree to a float param tree (the specs for "blocks"
    broadcast over the per-layer list)."""
    axis = next(a for s in _leaves(specs) for a in s if a is not None)

    def tree(p, spec, key=None):
        if isinstance(spec, dict):
            return {k: tree(p[k], spec[k], k) for k in p if not k.startswith("_")}
        if _axis(mesh, spec) is None:
            return _replicate(mesh, p, axis)
        return _place(mesh, p, spec, key)

    out = {}
    for key, val in params.items():
        if key.startswith("_"):  # cached copies (the fp32 head)
            continue
        if key == "blocks":
            out[key] = [tree(blk, specs[key]) for blk in val]
        else:
            out[key] = tree(val, specs[key], key)
    return out


def _leaves(spec):
    if isinstance(spec, dict):
        for v in spec.values():
            yield from _leaves(v)
    else:
        yield spec


def _split_weight(w, kind: str, mesh, tp_axis: str):
    """A weight of any quantized or float kind -> its ShardedWeight:
    "col" splits N in the values and every scale, "row" splits K in the
    values and in grouped scales (per-column scales are whole on every
    rank); a row split of int4 must fall on group boundaries."""
    n = len(mesh.axis_devices(tp_axis))
    devs = mesh.axis_devices(tp_axis)

    def cut(x, dim):
        spec = [None] * x.ndim
        spec[dim] = tp_axis
        return shard(mesh, x, tuple(spec))

    def whole(x):
        return [x.to(d) for d in devs]

    col = kind == "col"
    if isinstance(w, BiasedWeight):
        # the bias is added once, after the gather or the sum
        return BiasedWeight(_split_weight(w.w, kind, mesh, tp_axis),
                            _replicate(mesh, w.bias, tp_axis))
    if isinstance(w, (Int4Weight, W4A8Weight)):
        K, N = w.shape
        if not col and (K // w.group_size) % n:
            raise ValueError(f"a row-parallel int4 split must fall on group boundaries: "
                             f"(K // group_size) % tp == 0, got K={K}, "
                             f"group_size={w.group_size}, tp={n}")
        packed, scales = cut(w.packed, 1 if col else 0), cut(w.scales, 1 if col else 0)
        shape = (K, N // n) if col else (K // n, N)
        parts = [type(w)(p, s, w.group_size, shape) for p, s in zip(packed, scales)]
    elif isinstance(w, W8A8Weight):
        vals = cut(w.vals, 1 if col else 0)
        scales = cut(w.scales, 0) if col else whole(w.scales)
        parts = [W8A8Weight(v, s) for v, s in zip(vals, scales)]
    elif _is_legacy_w8a8(w):
        vals = cut(w[1], 1 if col else 0)
        scales = cut(w[2], 0) if col else whole(w[2])
        parts = [("w8a8", v, s) for v, s in zip(vals, scales)]
    elif isinstance(w, tuple):  # int8 (vals, scales [N] or [K//g, N])
        vals, scales = w
        vs = cut(vals, 1 if col else 0)
        if col:
            ss = cut(scales, scales.ndim - 1)
        else:
            ss = cut(scales, 0) if scales.ndim == 2 else whole(scales)
        parts = list(zip(vs, ss))
    else:
        parts = cut(w, 1 if col else 0)
    return ShardedWeight(kind, parts, mesh)


def shard_params_quant(params: dict, mesh, tp_axis: str = TENSOR_AXIS, *,
                       consume: bool = False) -> dict:
    """Shard a ``llama.quantize_weights`` tree (int8 tuples, ``Int4Weight``,
    ``W4A8Weight``, ``W8A8Weight`` or float leaves) with the Megatron
    column/row rules of ``llama_param_specs`` (BASELINE config 4).  A
    fused tree (``wqkv``, ``w_gate_up``) raises ``ValueError``: the fused
    output axis does not align with per-rank column shards.  ``consume``
    empties ``params`` as it goes, each layer dropped once it is sharded,
    so that a model that fills most of one card is never held twice."""
    for blk in params["blocks"]:
        _refuse_fused(blk)
    take = params.pop if consume else params.__getitem__
    out = {"tok_emb": _place(mesh, take("tok_emb"), (tp_axis, None), "tok_emb"),
           "final_norm": _replicate(mesh, take("final_norm"), tp_axis),
           "lm_head": _split_weight(take("lm_head"), "col", mesh, tp_axis),
           "blocks": []}
    blocks = params["blocks"]
    for i in range(len(blocks)):
        out["blocks"].append(_shard_block(blocks[i], mesh, tp_axis))
        if consume:
            blocks[i] = None
    if consume:
        params.clear()
    return out


def _shard_block(blk: dict, mesh, tp_axis: str) -> dict:
    nb = {}
    for name, w in blk.items():
        if name in _LLAMA_COL:
            nb[name] = _split_weight(w, "col", mesh, tp_axis)
        elif name in _LLAMA_ROW:
            nb[name] = _split_weight(w, "row", mesh, tp_axis)
        else:  # norms
            nb[name] = _replicate(mesh, w, tp_axis)
    return nb


def _refuse_fused(blk: dict):
    for name in ("wqkv", "w_gate_up"):
        if name in blk:
            raise ValueError(
                f"shard_params_quant got fused projection {name!r}: TP requires the "
                "unfused param tree (shard first, or skip fuse_projections)")
