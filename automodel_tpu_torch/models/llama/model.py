"""Llama (counterpart of ``automodel_tpu/models/llama/model.py``) and every member of
its lineage that the JAX package builds from the same class, through
``LlamaConfig.from_hf``: Qwen2 (q/k/v biases), Qwen3 (per-head q/k RMSNorm), Mistral (a
sliding window), Granite (four multipliers), SmolLM3 (NoPE layers), OLMo-2 / OLMo-3
(post-sublayer norms, the whole-projection q/k RMSNorm), Cohere (mean-centred LayerNorm,
the parallel block, interleaved RoPE, the logit scale; Cohere+'s per-head q/k
LayerNorm), Cohere2 (its 3:1 sliding pattern with RoPE on the sliding layers only),
Arcee (the ungated relu^2 MLP) and, through their own classes, GLM / GLM-4 and
Ministral-3.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from automodel_tpu_torch.models.common.backend import BackendConfig
from automodel_tpu_torch.models.common.param_module import ParamModule
from automodel_tpu_torch.models.common.transformer import (
    DenseDecoderConfig, decoder_forward, init_dense_decoder_params,
)

__all__ = ["LlamaConfig", "LlamaForCausalLM"]


def _archs(hf: dict[str, Any]) -> str:
    return "".join(hf.get("architectures") or [])


def _is_olmo2(hf: dict[str, Any]) -> bool:
    archs = _archs(hf)
    return "Olmo2" in archs or "Olmo3" in archs


def _cohere2_layer_types(hf: dict[str, Any]) -> list[str]:
    """Cohere2's per-layer pattern: its layer_types, or, in the original R7B config.json,
    derived from the integer sliding_window_pattern as Cohere2Config's compatibility
    branch derives it (every pattern-th layer attends in full)."""
    if hf.get("layer_types"):
        return hf["layer_types"]
    p = int(hf.get("sliding_window_pattern", 4))
    return ["sliding_attention" if (i + 1) % p else "full_attention"
            for i in range(hf["num_hidden_layers"])]


def _no_rope_layers(hf: dict[str, Any]) -> list[int] | None:
    """Per-layer RoPE (1 = on), or None when every layer takes it: SmolLM3's
    no_rope_layers, or every no_rope_layer_interval-th layer without; Cohere2's RoPE on
    its sliding layers only."""
    layers = hf.get("no_rope_layers")
    if layers is None and hf.get("no_rope_layer_interval"):
        k = int(hf["no_rope_layer_interval"])
        layers = [int((i + 1) % k != 0) for i in range(hf["num_hidden_layers"])]
    if layers is None and "Cohere2" in _archs(hf):
        layers = [int(t == "sliding_attention") for t in _cohere2_layer_types(hf)]
    if layers is not None and all(layers):
        return None
    return layers


@dataclasses.dataclass
class LlamaConfig(DenseDecoderConfig):
    @classmethod
    def from_hf(cls, hf: dict[str, Any]) -> "LlamaConfig":
        """Build from an HF config.json dict of the lineage, as the JAX package reads it."""
        archs = _archs(hf)
        is_cohere = "Cohere" in archs
        is_glm4 = "Glm4" in archs
        is_glm = "Glm" in archs  # GLM and GLM-4: interleaved partial RoPE
        is_arcee = "Arcee" in archs
        return cls(
            vocab_size=hf["vocab_size"],
            hidden_size=hf["hidden_size"],
            intermediate_size=hf["intermediate_size"],
            num_hidden_layers=hf["num_hidden_layers"],
            num_attention_heads=hf["num_attention_heads"],
            num_key_value_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
            head_dim=hf.get("head_dim"),
            max_position_embeddings=hf.get("max_position_embeddings", 4096),
            rope_theta=hf.get("rope_theta", 10000.0),
            rope_scaling=hf.get("rope_scaling"),
            partial_rotary_factor=hf.get("partial_rotary_factor", 1.0),
            rms_norm_eps=hf.get("rms_norm_eps", hf.get("layer_norm_eps", 1e-5)),
            tie_word_embeddings=hf.get("tie_word_embeddings", is_cohere),
            attention_bias=hf.get("attention_bias", hf.get("qkv_bias", False)),
            qk_norm="Qwen3" in archs or (is_cohere and hf.get("use_qk_norm", False)),
            qk_norm_whole=_is_olmo2(hf),
            norm_placement="post" if _is_olmo2(hf) else "sandwich" if is_glm4 else "pre",
            norm_type="layernorm" if is_cohere else "rms",
            parallel_block=is_cohere,
            mlp_gated=not is_arcee,
            mlp_act="relu2" if is_arcee else "silu",
            rope_interleaved=is_cohere or is_glm,
            sliding_window=(hf.get("sliding_window") if hf.get("use_sliding_window", True)
                            else None),
            layer_types=(_cohere2_layer_types(hf) if "Cohere2" in archs
                         else hf.get("layer_types")),
            no_rope_layers=_no_rope_layers(hf),
            initializer_range=hf.get("initializer_range", 0.02),
            embedding_multiplier=hf.get("embedding_multiplier", 1.0),
            residual_multiplier=hf.get("residual_multiplier", 1.0),
            attention_multiplier=hf.get("attention_multiplier"),
            # Cohere's logit_scale multiplies the logits: dividing by its inverse
            logits_scaling=(1.0 / hf["logit_scale"] if is_cohere and hf.get("logit_scale")
                            else hf.get("logits_scaling", 1.0)),
        )


class LlamaForCausalLM(ParamModule):
    """Holds the parameters (JAX layout, flat names) and runs the dense decoder."""

    config_class = LlamaConfig

    def __init__(self, config: LlamaConfig, backend: BackendConfig | None = None, *,
                 device: torch.device | str = "cuda", dtype=torch.float32,
                 generator: torch.Generator | None = None,
                 params: dict[str, torch.Tensor] | None = None):
        """Random weights from ``generator`` (seed 0 by default), or ``params`` as given
        (``models/auto.py`` passes a checkpoint's, already on their device)."""
        device = torch.device(device)
        if params is None and generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        super().__init__(params if params is not None
                         else init_dense_decoder_params(config, generator, dtype, device))
        self.config = config
        self.backend = backend or BackendConfig()

    @classmethod
    def from_config(cls, config: LlamaConfig | dict, backend: BackendConfig | None = None,
                    **kw) -> "LlamaForCausalLM":
        if isinstance(config, dict):
            config = cls.config_class.from_hf(config)
        return cls(config, backend, **kw)

    def state_dict_adapter(self):
        from automodel_tpu_torch.models.llama.state_dict_adapter import LlamaStateDictAdapter

        return LlamaStateDictAdapter(self.config)

    def forward(self, input_ids, positions=None, segment_ids=None, return_hidden=False,
                mesh=None, params=None):
        """``params``: run on these tensors instead of the module's (a LoRA merge)."""
        return decoder_forward(self.config, self.backend,
                               self.param_dict() if params is None else params, input_ids,
                               positions=positions, segment_ids=segment_ids,
                               return_hidden=return_hidden, mesh=mesh)
