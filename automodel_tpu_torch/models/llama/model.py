"""Llama (counterpart of ``automodel_tpu/models/llama/model.py``), plain lineage only.

``LlamaConfig.from_hf`` reads an HF config.json dict. The branches the JAX package
takes for other members of the lineage (Qwen2/3 biases and qk-norm, Olmo2, Cohere,
GLM, Arcee, Granite multipliers, NoPE layers, sliding windows) raise
NotImplementedError until a slice ports them.
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

_ARCHS = ("LlamaForCausalLM", "MistralForCausalLM")


def _unsupported(hf: dict[str, Any]) -> list[str]:
    found = []
    archs = hf.get("architectures") or ["LlamaForCausalLM"]
    found += [f"architecture {a}" for a in archs if a not in _ARCHS]
    if hf.get("attention_bias") or hf.get("qkv_bias"):
        found.append("attention_bias")
    if hf.get("mlp_bias"):
        found.append("mlp_bias")
    if hf.get("sliding_window") is not None and hf.get("use_sliding_window", True):
        found.append("sliding_window")
    for key in ("layer_types", "no_rope_layers", "no_rope_layer_interval", "logit_scale",
                "attention_multiplier", "llama4_attn_scale_beta"):
        if hf.get(key):
            found.append(key)
    for key in ("embedding_multiplier", "residual_multiplier", "logits_scaling",
                "partial_rotary_factor"):
        if hf.get(key, 1.0) != 1.0:
            found.append(key)
    if hf.get("hidden_act", "silu") != "silu":
        found.append(f"hidden_act {hf['hidden_act']}")
    return found


@dataclasses.dataclass
class LlamaConfig(DenseDecoderConfig):
    @classmethod
    def from_hf(cls, hf: dict[str, Any]) -> "LlamaConfig":
        """Build from an HF config.json dict of the plain Llama lineage."""
        bad = _unsupported(hf)
        if bad:
            raise NotImplementedError(
                f"LlamaConfig.from_hf: {', '.join(bad)} not ported to the PyTorch package yet")
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
            rms_norm_eps=hf.get("rms_norm_eps", 1e-5),
            tie_word_embeddings=hf.get("tie_word_embeddings", False),
            initializer_range=hf.get("initializer_range", 0.02),
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
            config = LlamaConfig.from_hf(config)
        return cls(config, backend, **kw)

    def state_dict_adapter(self):
        from automodel_tpu_torch.models.llama.state_dict_adapter import LlamaStateDictAdapter

        return LlamaStateDictAdapter(self.config)

    def forward(self, input_ids, positions=None, segment_ids=None, return_hidden=False,
                mesh=None):
        return decoder_forward(self.config, self.backend, self.param_dict(), input_ids,
                               positions=positions, segment_ids=segment_ids,
                               return_hidden=return_hidden, mesh=mesh)
