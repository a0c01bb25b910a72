"""Logical axes of every parameter, as plain data (counterpart of the JAX package's
``dense_decoder_logical_axes``, ``moe_decoder_logical_axes`` and the families'
``logical_axes()``).

The port does not shard by them yet; LoRA's and QAT's matching read them
(``peft/lora.py``): which leading dims stack independent matrices (``layers``,
``expert``), where a weight's fan-in ends (after ``heads, head_dim`` for an attention
output) and which tensors are norms. The tables are the JAX package's, name for name.
"""

from __future__ import annotations

__all__ = ["DENSE_LAYER_AXES", "GEMMA_LAYER_AXES", "HEAD_QK_NORM_AXES", "MLA_LAYER_AXES",
           "MOE_BLOCK_AXES", "QWEN3_NEXT_LAYER_AXES", "STEP3P5_LAYER_AXES", "logical_axes"]

Axes = tuple[str | None, ...]

# JAX models/common/transformer.py _LAYER_AXES
DENSE_LAYER_AXES: dict[str, Axes] = {
    "attn_norm": ("norm",),
    "wq": ("embed", "heads", "head_dim"),
    "wk": ("embed", "kv_heads", "head_dim"),
    "wv": ("embed", "kv_heads", "head_dim"),
    "wo": ("heads", "head_dim", "embed"),
    "bq": ("heads", "head_dim"),
    "bk": ("kv_heads", "head_dim"),
    "bv": ("kv_heads", "head_dim"),
    "bo": ("embed",),
    "sinks": ("heads",),
    "q_norm": ("norm",),
    "k_norm": ("norm",),
    "mlp_norm": ("norm",),
    "attn_post_norm": ("norm",),
    "mlp_post_norm": ("norm",),
    "w_gate": ("embed", "mlp"),
    "w_up": ("embed", "mlp"),
    "w_down": ("mlp", "embed"),
    "b_gate": ("mlp",),
    "b_up": ("mlp",),
    "b_down": ("embed",),
    "attn_norm_b": ("norm",),
    "mlp_norm_b": ("norm",),
}

# JAX dense_decoder_logical_axes: the (heads, head_dim) q / k norms of qk_norm_whole (OLMo-2)
# and of Cohere+'s per-head LayerNorm
HEAD_QK_NORM_AXES: dict[str, Axes] = {"q_norm": ("heads", "head_dim"),
                                      "k_norm": ("kv_heads", "head_dim")}

# JAX models/gemma/model.py _LAYER_AXES
GEMMA_LAYER_AXES: dict[str, Axes] = {
    "attn_norm": ("norm",), "post_attn_norm": ("norm",),
    "pre_ffn_norm": ("norm",), "post_ffn_norm": ("norm",),
    "wq": ("embed", "heads", None), "wk": ("embed", "kv_heads", None),
    "wv": ("embed", "kv_heads", None), "wo": ("heads", None, "embed"),
    "w_gate": ("embed", "mlp"), "w_up": ("embed", "mlp"), "w_down": ("mlp", "embed"),
    "q_norm": ("norm",), "k_norm": ("norm",),
}

# JAX models/deepseek_v3/model.py _MLA_AXES, with the dense prefix's MLP
# (moe_transformer.py _DENSE_MLP_AXES)
MLA_LAYER_AXES: dict[str, Axes] = {
    "attn_norm": ("norm",),
    "mlp_norm": ("norm",),
    "wq": ("embed", "heads", "head_dim"),
    "wq_a": ("embed", None),
    "q_a_norm": ("norm",),
    "wq_b": (None, "heads", "head_dim"),
    "wkv_a": ("embed", None),
    "kv_a_norm": ("norm",),
    "wkv_b": (None, "heads", "head_dim"),
    "wo": ("heads", "head_dim", "embed"),
    "w_gate": ("embed", "mlp"), "w_up": ("embed", "mlp"), "w_down": ("mlp", "embed"),
}

# JAX models/step3p5/model.py _AXES (every stream's)
STEP3P5_LAYER_AXES: dict[str, Axes] = {
    "attn_norm": ("norm",), "mlp_norm": ("norm",),
    "wq": ("embed", "heads", "head_dim"), "wk": ("embed", "kv_heads", "head_dim"),
    "wv": ("embed", "kv_heads", "head_dim"), "wo": ("heads", "head_dim", "embed"),
    "q_norm": ("norm",), "k_norm": ("norm",), "wg": ("embed", "heads"),
    "w_gate": ("embed", "mlp"), "w_up": ("embed", "mlp"), "w_down": ("mlp", "embed"),
    "sh_gate": ("embed", "mlp"), "sh_up": ("embed", "mlp"), "sh_down": ("mlp", "embed"),
}

# JAX models/qwen3_next/model.py _LINEAR_AXES and _FULL_AXES (no name differs between them)
QWEN3_NEXT_LAYER_AXES: dict[str, Axes] = {
    "attn_norm": ("norm",), "mlp_norm": ("norm",),
    "wqkvz": ("embed", "kv_heads", "head_dim"), "wba": ("embed", "kv_heads", "head_dim"),
    "conv_w": (None, None), "dt_bias": ("heads",), "a_log": ("heads",), "norm": ("norm",),
    "wq": ("embed", "heads", "head_dim"), "wk": ("embed", "kv_heads", "head_dim"),
    "wv": ("embed", "kv_heads", "head_dim"), "wo": ("heads", "head_dim", "embed"),
    "q_norm": ("norm",), "k_norm": ("norm",),
}

# JAX moe/layers.py moe_logical_axes (gate.py, experts.py), by the MoE block's names
MOE_BLOCK_AXES: dict[str, Axes] = {
    "gate.weight": (None, "embed"),
    "gate.bias": (None,),
    "gate.score_correction_bias": (None,),
    "experts.gate_up_proj": ("expert", "expert_embed", "expert_mlp"),
    "experts.down_proj": ("expert", "expert_mlp", "expert_embed"),
    "experts.gate_up_bias": ("expert", "expert_mlp"),
    "experts.down_bias": ("expert", "expert_embed"),
    "shared_experts.w_up": ("embed", "mlp"),
    "shared_experts.w_gate": ("embed", "mlp"),
    "shared_experts.w_down": ("mlp", "embed"),
    "shared_expert_gate": ("embed", None),
}

_TOP: dict[str, Axes] = {"embed": ("vocab", "embed"), "final_norm": ("norm",),
                         "final_norm_b": ("norm",), "lm_head": ("embed", "vocab")}
# a stack's name -> the logical axis of its leading dim (the dense prefix of an MoE model
# has its own, as in JAX, so that it is not sharded over pp)
# (Step-3.5's four streams and Qwen3-Next's two stacks are layer stacks too)
_STACKS = {"layers": "layers", "moe_layers": "layers", "dense_layers": "dense_layers",
           **{f"{a}_{f}": "layers" for a in ("full", "sliding") for f in ("mlp", "moe")},
           "linear_layers": "layers", "full_layers": "layers"}


def logical_axes(shapes: dict[str, tuple[int, ...]],
                 layer_axes: dict[str, Axes] = DENSE_LAYER_AXES) -> dict[str, Axes]:
    """Flat name -> logical axes of each parameter of ``shapes`` (name -> shape, as
    ``param_shapes()`` gives, under the port's flat names: ``layers.wq``,
    ``moe_layers.moe.experts.down_proj``; the shape tells (heads, head_dim) q/k norms from
    (head_dim,) ones); ``layer_axes`` is the family's per-layer table. Raises KeyError on
    a name no table knows."""
    out: dict[str, Axes] = {}
    for name in shapes:
        if name in _TOP:
            out[name] = _TOP[name]
            continue
        stack, _, rest = name.partition(".")
        if rest.startswith("moe."):
            axes = MOE_BLOCK_AXES[rest[len("moe."):]]
        elif rest in HEAD_QK_NORM_AXES and len(shapes[name]) == 3:
            axes = HEAD_QK_NORM_AXES[rest]
        else:
            axes = layer_axes[rest]
        out[name] = (_STACKS[stack],) + axes
    return out
