"""Structural aliasing of unregistered HF architectures onto the Llama lineage
(counterpart of ``automodel_tpu/models/structural.py``; its tables are copied here, as
the port imports nothing of the JAX package).

Most ``*ForCausalLM`` architectures are Llama deltas: the same decoder, varying only in
config-level geometry. For an architecture the registry does not know, every field of
its config.json is checked against the lineage's semantics; it maps onto the port's
Llama (:class:`AliasedLlamaForCausalLM`, whose config class reads it through
:func:`aliased_config`) when every field is consumed, cosmetic or pinned at the Llama
value, with the per-architecture deltas of ``_ARCH_DELTAS`` (Helium, Ernie-4.5, OLMo v1,
StarCoder2, StableLM), and raises :class:`StructuralDivergence` naming each divergent
field otherwise, with JAX's messages.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any

from automodel_tpu_torch.models.llama.model import LlamaConfig, LlamaForCausalLM

logger = logging.getLogger(__name__)

__all__ = ["AliasedLlamaConfig", "AliasedLlamaForCausalLM", "StructuralDivergence",
           "alias_overrides", "aliased_config", "classify_config"]


class StructuralDivergence(Exception):
    """The config genuinely diverges from the llama lineage; message names the field."""


# Code-level deltas that ARE expressible as dense-decoder config knobs but are
# invisible in the arch's config.json — verified by the logits-parity suite.
# (Helium/Ernie rotate consecutive element pairs where llama rotates the
# half-split; both implementations exist in ops/rope.py.) Values are either a
# static dict or a callable(hf_config) -> dict for deltas that read config
# values the llama from_hf doesn't consume.
_ARCH_DELTAS = {
    "HeliumForCausalLM": {"rope_interleaved": True},
    "Ernie4_5ForCausalLM": {"rope_interleaved": True},
    # OLMo v1: NON-PARAMETRIC LayerNorm (no weight, no bias, eps pinned 1e-5
    # in code — transformers OlmoLayerNorm) + optional qkv clamping
    "OlmoForCausalLM": lambda hf: {
        "norm_type": "layernorm", "norm_param": False, "rms_norm_eps": 1e-5,
        "clip_qkv": hf.get("clip_qkv"),
    },
    # Starcoder2: affine LayerNorm (weight+bias), ungated c_fc/c_proj MLP with
    # tanh-gelu, biases on every linear (use_bias)
    "Starcoder2ForCausalLM": lambda hf: {
        "norm_type": "layernorm", "norm_bias": True,
        "rms_norm_eps": hf.get("norm_epsilon", 1e-5),
        "mlp_gated": False,
        # HF "gelu_pytorch_tanh" == our tanh-approx "gelu"; bare HF "gelu" is
        # the EXACT erf form — mapping it to the tanh approximation would
        # diverge ~1e-3, far past the parity bar
        "mlp_act": ("gelu_exact" if hf.get("hidden_act") == "gelu" else "gelu"),
        "hf_mlp_names": ("c_fc", "c_proj"),
        "mlp_bias": bool(hf.get("use_bias", True)),
        "attention_bias": bool(hf.get("use_bias", True)),
        "attention_out_bias": bool(hf.get("use_bias", True)),
    },
    # StableLM: affine LayerNorm + partial rope (partial_rotary_factor is
    # consumed by from_hf) + optional parallel residual / qkv bias
    "StableLmForCausalLM": lambda hf: {
        "norm_type": "layernorm", "norm_bias": True,
        "rms_norm_eps": hf.get("layer_norm_eps", 1e-5),
        "attention_bias": bool(hf.get("use_qkv_bias", False)),
        "parallel_block": bool(hf.get("use_parallel_residual", False)),
    },
}

# Per-arch extra config fields the delta itself consumes (bypassing the
# generic gates); each maps to a predicate over the value so a checkpoint
# with an UNEXPECTED value still fails loudly instead of silently mis-mapping.
_ARCH_FIELDS = {
    "OlmoForCausalLM": {"clip_qkv": lambda v: True},
    "Starcoder2ForCausalLM": {
        "use_bias": lambda v: True,
        "norm_epsilon": lambda v: True,
        "hidden_act": lambda v: v in ("gelu_pytorch_tanh", "gelu"),
        "residual_dropout": lambda v: not v,
        "embedding_dropout": lambda v: not v,
    },
    "StableLmForCausalLM": {
        "use_qkv_bias": lambda v: True,
        "use_parallel_residual": lambda v: True,
        "layer_norm_eps": lambda v: True,
        # per-head qk LayerNorm (stablelm-2-12b) is NOT mapped; default False
        # checkpoints pass, qk_layernorm=True fails via the generic gate
    },
}

# rope_scaling variants ops/rope.py::rope_frequencies implements
_ROPE_TYPES = {None, "default", "linear", "llama3", "longrope", "yarn"}

# Fields LlamaConfig.from_hf / DenseDecoderConfig consume (models/llama/model.py).
_CONSUMED = {
    "vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
    "num_attention_heads", "num_key_value_heads", "head_dim",
    "max_position_embeddings", "rope_theta", "rms_norm_eps",
    "tie_word_embeddings", "attention_bias", "qkv_bias", "sliding_window",
    "use_sliding_window", "layer_types", "initializer_range",
    "partial_rotary_factor",
    "embedding_multiplier", "residual_multiplier", "attention_multiplier",
    "logits_scaling", "no_rope_layers", "no_rope_layer_interval",
}

# Fields that never change the computation (identity, tokenizer ids, runtime
# knobs the decoder does not have).
_COSMETIC = {
    "architectures", "model_type", "torch_dtype", "dtype",
    "transformers_version", "_name_or_path", "name_or_path", "auto_map",
    "bos_token_id", "eos_token_id", "pad_token_id", "sep_token_id",
    "unk_token_id", "use_cache", "tokenizer_class", "chat_template",
    "attn_implementation", "_attn_implementation",
    "_attn_implementation_autoset", "output_attentions",
    "output_hidden_states", "return_dict", "use_bfloat16",
    "use_return_dict", "is_decoder", "add_cross_attention", "task_specific_params",
    "gradient_checkpointing", "use_flash_attention_2",
    # PretrainedConfig boilerplate (generation defaults, label maps, export
    # knobs) that transformers serializes but that never touches the math
    "torchscript", "pruned_heads", "chunk_size_feed_forward",
    "is_encoder_decoder", "cross_attention_hidden_size", "tie_encoder_decoder",
    "finetuning_task", "id2label", "label2id", "problem_type", "prefix",
    "decoder_start_token_id", "max_length", "min_length", "do_sample",
    "early_stopping", "num_beams", "num_beam_groups", "diversity_penalty",
    "temperature", "top_k", "top_p", "typical_p", "repetition_penalty",
    "length_penalty", "no_repeat_ngram_size", "encoder_no_repeat_ngram_size",
    "bad_words_ids", "num_return_sequences", "output_scores",
    "return_dict_in_generate", "forced_bos_token_id", "forced_eos_token_id",
    "remove_invalid_values", "exponential_decay_length_penalty",
    "suppress_tokens", "begin_suppress_tokens", "tf_legacy_loss",
    "tokenizer_file", "full_vocab_size",
}

_FALSY = lambda v: not v
_NONE = lambda v: v is None
_ONE = lambda v: v in (None, 1, 1.0)

# Fields accepted only at the value where they mean "same math as llama".
# Each entry: (predicate, human reason used when the predicate fails).
_GATED = {
    "rope_scaling": (
        lambda v: v is None or v.get("rope_type", v.get("type", "default")) in _ROPE_TYPES,
        "rope_scaling variant is not implemented by ops/rope.py",
    ),
    "use_bias": (_FALSY, "linear-layer bias terms are not part of the lineage"),
    "hidden_act": (lambda v: v in ("silu", "swish"), "MLP activation is not gated SiLU"),
    "hidden_activation": (lambda v: v in (None, "silu", "swish"), "MLP activation is not gated SiLU"),
    "activation_function": (lambda v: v in ("silu", "swish"), "MLP activation is not gated SiLU"),
    "mlp_bias": (_FALSY, "llama-lineage MLP has no bias terms"),
    "attention_dropout": (_FALSY, "attention dropout is not part of the lineage"),
    "attn_pdrop": (_FALSY, "attention dropout is not part of the lineage"),
    "resid_pdrop": (_FALSY, "residual dropout is not part of the lineage"),
    "embd_pdrop": (_FALSY, "embedding dropout is not part of the lineage"),
    "hidden_dropout": (_FALSY, "hidden dropout is not part of the lineage"),
    "hidden_dropout_prob": (_FALSY, "hidden dropout is not part of the lineage"),
    "dropout": (_FALSY, "dropout is not part of the lineage"),
    "clip_qkv": (_NONE, "QKV clipping changes the attention math"),
    "pretraining_tp": (_ONE, "pretraining_tp slicing changes the matmul order"),
    "rope_interleaved": (_FALSY, "interleaved rope pairs differ from half-rotation rope"),
    # granite's four mup-style scalars are CONSUMED by DenseDecoderConfig
    # (LlamaConfig.from_hf reads them; transformer.py applies them)
    "logit_scale": (_ONE, "output-logit scaling (cohere convention) is not the granite field"),
    "final_logit_softcapping": (_NONE, "logit soft-capping is the gemma lineage"),
    "attn_logit_softcapping": (_NONE, "attention soft-capping is the gemma lineage"),
    # SmolLM3 NoPE layers are CONSUMED (llama/model.py _no_rope_layers ->
    # DenseDecoderConfig.no_rope_layers, applied per layer via nope_flags)
    "num_experts": (_NONE, "mixture-of-experts MLP (use a registered MoE family)"),
    "num_local_experts": (_NONE, "mixture-of-experts MLP (use a registered MoE family)"),
    "n_routed_experts": (_NONE, "mixture-of-experts MLP (use a registered MoE family)"),
    "moe_intermediate_size": (_NONE, "mixture-of-experts MLP (use a registered MoE family)"),
    "kv_lora_rank": (_NONE, "MLA latent attention (use the DeepseekV3 family)"),
    "q_lora_rank": (_NONE, "MLA latent attention (use the DeepseekV3 family)"),
    "ssm_cfg": (_NONE, "state-space layers (use the NemotronH family)"),
    "layer_norm_eps": (_NONE, "LayerNorm (not RMSNorm) normalization"),
    "layer_norm_epsilon": (_NONE, "LayerNorm (not RMSNorm) normalization"),
    "norm_eps": (_NONE, "ambiguous norm type (rms_norm_eps is the lineage field)"),
    "parallel_attn": (_FALSY, "parallel attention+MLP block"),
    "qk_layernorm": (_FALSY, "whole-projection QK LayerNorm differs from per-head QK-RMSNorm"),
    # per-head qwen3-style QK-RMSNorm IS supported — consumed below
    "use_qk_norm": (lambda v: True, ""),
    "qk_norm": (lambda v: True, ""),
    "max_window_layers": (lambda v: True, ""),  # inert unless use_sliding_window, which _CONSUMED covers
}


def classify_config(hf: dict, architecture: str | None = None) -> list[str]:
    """Return a list of human-readable divergences (empty == llama delta)."""
    arch_fields = _ARCH_FIELDS.get(architecture, {})
    problems = []
    for key, value in hf.items():
        if key in _CONSUMED or key in _COSMETIC or key.startswith("_"):
            continue
        arch_gate = arch_fields.get(key)
        if arch_gate is not None:
            if not arch_gate(value):
                problems.append(
                    f"{key}={value!r} (outside the {architecture} delta's "
                    "supported range)")
            continue
        gate = _GATED.get(key)
        if gate is None:
            problems.append(f"{key}={value!r} (field unknown to the llama lineage)")
        elif not gate[0](value):
            problems.append(f"{key}={value!r} ({gate[1]})")
    return problems


def alias_overrides(architecture: str, hf: dict[str, Any]) -> dict[str, Any]:
    """The dense-decoder fields that an unregistered ``*ForCausalLM`` config sets on top of
    ``LlamaConfig.from_hf``; raises :class:`StructuralDivergence` naming the divergent
    field(s), as JAX's ``resolve_llama_delta``."""
    if not architecture.endswith("ForCausalLM"):
        raise StructuralDivergence(
            f"{architecture} is not a causal-LM architecture; structural "
            "auto-aliasing covers *ForCausalLM configs only."
        )
    raw_delta = _ARCH_DELTAS.get(architecture, {})
    overrides = dict(raw_delta(hf) if callable(raw_delta) else raw_delta)
    problems = classify_config(hf, architecture)
    if "rms_norm_eps" not in hf and "norm_type" not in overrides:
        # configs that omit it are usually NOT RMSNorm; an absent field is as
        # structural as a wrong one — unless the arch delta pins the norm type
        problems.insert(0, "rms_norm_eps missing (norm type unknown — the "
                           "llama lineage is parametric RMSNorm)")
    if problems:
        raise StructuralDivergence(
            f"{architecture} diverges from the llama lineage on: "
            + "; ".join(problems)
            + ". If the divergence is cosmetic for your checkpoint, register "
            "an explicit mapping with automodel_tpu_torch.models.registry.MODEL_REGISTRY."
        )
    if hf.get("qk_norm") or hf.get("use_qk_norm"):
        overrides["qk_norm"] = True
    return overrides


def aliased_config(architecture: str, hf: dict[str, Any]) -> LlamaConfig:
    """The Llama config of an unregistered ``*ForCausalLM`` config, with its
    architecture's deltas (:func:`alias_overrides`, which raises on a divergent one)."""
    overrides = alias_overrides(architecture, hf)
    cfg = LlamaConfig.from_hf(hf)  # consumes partial_rotary_factor directly
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    logger.info(
        "architecture %s auto-aliased onto the llama lineage (structural field "
        "check passed%s) — verify held-out logits before trusting a large run",
        architecture, f"; deltas: {overrides}" if overrides else "",
    )
    return cfg


@dataclasses.dataclass
class AliasedLlamaConfig(LlamaConfig):
    """The Llama config of an aliased architecture (read by :func:`aliased_config`)."""

    @classmethod
    def from_hf(cls, hf: dict[str, Any]) -> "AliasedLlamaConfig":
        arch = (hf.get("architectures") or ["LlamaForCausalLM"])[0]
        return cls(**dataclasses.asdict(aliased_config(arch, hf)))


class AliasedLlamaForCausalLM(LlamaForCausalLM):
    """An unregistered Llama-delta architecture on the port's Llama."""

    config_class = AliasedLlamaConfig
