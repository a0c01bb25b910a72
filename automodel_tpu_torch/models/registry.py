"""HF architecture name -> the port's model class (counterpart of
``automodel_tpu/models/registry.py`` for the families the port has). Names the JAX
registry sends to its Llama lineage go to the port's Llama; an unregistered
``*ForCausalLM`` goes through ``models/structural.py`` (``models/auto.py``)."""

from __future__ import annotations

import importlib

__all__ = ["MODEL_REGISTRY", "resolve_model_class"]

_LLAMA = "automodel_tpu_torch.models.llama.model:LlamaForCausalLM"
_DEEPSEEK = "automodel_tpu_torch.models.deepseek_v3.model:DeepseekV3ForCausalLM"
MODEL_REGISTRY: dict[str, str] = {
    **{arch: _LLAMA for arch in (
        "LlamaForCausalLM", "Qwen2ForCausalLM", "Qwen3ForCausalLM", "MistralForCausalLM",
        "GraniteForCausalLM", "SmolLM3ForCausalLM", "Olmo2ForCausalLM", "Olmo3ForCausalLM",
        "CohereForCausalLM", "Cohere2ForCausalLM", "ArceeForCausalLM")},
    # GLM-4 dense (sandwich norms) and GLM: interleaved partial RoPE, fused gate_up
    **{arch: "automodel_tpu_torch.models.glm4.model:Glm4ForCausalLM" for arch in (
        "Glm4ForCausalLM", "GlmForCausalLM")},
    "Ministral3ForCausalLM": "automodel_tpu_torch.models.mistral3.model:Ministral3ForCausalLM",
    # the biencoder recipe's tower: Llama's trunk, non-causal, pooled
    "LlamaBidirectionalModel":
        "automodel_tpu_torch.models.llama_bidirectional.model:LlamaBidirectionalModel",
    "GPT2LMHeadModel": "automodel_tpu_torch.models.gpt2.model:GPT2LMHeadModel",
    "MixtralForCausalLM": "automodel_tpu_torch.models.mixtral.model:MixtralForCausalLM",
    "Phi3ForCausalLM": "automodel_tpu_torch.models.phi3.model:Phi3ForCausalLM",
    "Qwen3MoeForCausalLM": "automodel_tpu_torch.models.qwen3_moe.model:Qwen3MoeForCausalLM",
    "GptOssForCausalLM": "automodel_tpu_torch.models.gpt_oss.model:GptOssForCausalLM",
    # Gemma 2 / 3 (a multimodal Gemma-3 checkpoint loads its text backbone)
    **{arch: "automodel_tpu_torch.models.gemma.model:GemmaForCausalLM" for arch in (
        "Gemma2ForCausalLM", "Gemma3ForCausalLM", "Gemma3ForConditionalGeneration")},
    # MLA + noaux-tc MoE: V3, V2 (softmax routing), Kimi-K2 and GLM-4-MoE-Lite, whose
    # config.json files describe the same parameters
    **{arch: _DEEPSEEK for arch in ("DeepseekV3ForCausalLM", "DeepseekV2ForCausalLM",
                                    "KimiK2ForCausalLM", "Glm4MoeLiteForCausalLM")},
    "Glm4MoeForCausalLM": "automodel_tpu_torch.models.glm4_moe.model:Glm4MoeForCausalLM",
    "MiniMaxM2ForCausalLM": "automodel_tpu_torch.models.minimax_m2.model:MiniMaxM2ForCausalLM",
    "Step3p5ForCausalLM": "automodel_tpu_torch.models.step3p5.model:Step3p5ForCausalLM",
    # the gated DeltaNet hybrids (Qwen3.5-MoE: the text stack of either name)
    "Qwen3NextForCausalLM": "automodel_tpu_torch.models.qwen3_next.model:Qwen3NextForCausalLM",
    **{arch: "automodel_tpu_torch.models.qwen3_5_moe.model:Qwen3_5MoeForCausalLM" for arch in (
        "Qwen3_5MoeForCausalLM", "Qwen3_5MoeForConditionalGeneration")},
}


def resolve_model_class(architecture: str):
    """The model class of a registered HF architecture name; NotImplementedError for any
    other (``models/auto.py`` then tries the structural alias)."""
    target = MODEL_REGISTRY.get(architecture)
    if target is None:
        raise NotImplementedError(f"architecture {architecture!r} is not ported to the "
                                  f"PyTorch package yet (ported: {sorted(MODEL_REGISTRY)})")
    module, name = target.split(":")
    return getattr(importlib.import_module(module), name)
