"""GPT-OSS HF key and layout mapping (counterpart of
``automodel_tpu/models/gpt_oss/state_dict_adapter.py``).

HF stores the experts stacked: ``mlp.experts.gate_up_proj`` (E, D, 2I) with gate and up
interleaved on the last dim (gate at even columns, up at odd), and its bias (E, 2I)
likewise; the port's layout is [gate | up]. The MXFP4 release checkpoints
(``*_blocks`` / ``*_scales``) are not dequantized here, nor by the JAX loader: a
checkpoint holding them raises.
"""

from __future__ import annotations

from typing import Mapping

import torch

from automodel_tpu_torch.models.common.moe_transformer import MoEDecoderConfig
from automodel_tpu_torch.models.common.state_dict import Entry, MappingAdapter
from automodel_tpu_torch.models.llama.state_dict_adapter import _t
from automodel_tpu_torch.models.qwen3_moe.state_dict_adapter import attention_entries

__all__ = ["GptOssStateDictAdapter"]


def _deinterleave(w: torch.Tensor) -> torch.Tensor:
    """(..., 2I) interleaved -> (..., 2I) [gate | up]."""
    return torch.cat([w[..., 0::2], w[..., 1::2]], dim=-1)


def _interleave(w: torch.Tensor) -> torch.Tensor:
    inter = w.shape[-1] // 2
    return torch.stack([w[..., :inter], w[..., inter:]], dim=-1).reshape(w.shape).contiguous()


class GptOssStateDictAdapter(MappingAdapter):
    def __init__(self, cfg: MoEDecoderConfig):
        pre = "model.layers.{i}"
        entries = [
            Entry("model.embed_tokens.weight", "embed"),
            Entry("model.norm.weight", "final_norm"),
            *attention_entries(cfg, "moe_layers"),
            Entry(f"{pre}.mlp.router.weight", "moe_layers.moe.gate.weight"),
            Entry(f"{pre}.mlp.router.bias", "moe_layers.moe.gate.bias"),
            Entry(f"{pre}.mlp.experts.gate_up_proj", "moe_layers.moe.experts.gate_up_proj",
                  _deinterleave, _interleave),
            Entry(f"{pre}.mlp.experts.gate_up_proj_bias", "moe_layers.moe.experts.gate_up_bias",
                  _deinterleave, _interleave),
            Entry(f"{pre}.mlp.experts.down_proj", "moe_layers.moe.experts.down_proj"),
            Entry(f"{pre}.mlp.experts.down_proj_bias", "moe_layers.moe.experts.down_bias"),
        ]
        if not cfg.tie_word_embeddings:
            entries.append(Entry("lm_head.weight", "lm_head", _t, _t))
        super().__init__(entries, cfg.num_hidden_layers, num_experts=cfg.moe.n_routed_experts)

    def from_hf(self, tensors: Mapping[str, torch.Tensor], dtype: torch.dtype | None = None,
                device: torch.device | str | None = None) -> dict[str, torch.Tensor]:
        """As :meth:`MappingAdapter.from_hf`; MXFP4 ``*_blocks`` / ``*_scales`` tensors
        raise NotImplementedError by name."""
        quantized = sorted(k for k in tensors if k.endswith(("_blocks", "_scales")))
        if quantized:
            raise NotImplementedError(
                f"GPT-OSS checkpoint holds MXFP4 tensors ({', '.join(quantized[:4])}"
                f"{', ...' if len(quantized) > 4 else ''}): dequantize to bf16 first; neither "
                "package's loader dequantizes them")
        return super().from_hf(tensors, dtype=dtype, device=device)
