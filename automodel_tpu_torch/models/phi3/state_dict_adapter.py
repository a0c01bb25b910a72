"""Phi-3 HF key and layout mapping (counterpart of
``automodel_tpu/models/phi3/state_dict_adapter.py``): Llama's table, with HF's fused
``self_attn.qkv_proj.weight`` (q | k | v) and ``mlp.gate_up_proj.weight`` (gate | up) split
into the table's q / k / v / gate / up keys on the way in and fused again on the way out
(``to_hf`` and ``to_hf_lazy``), so the parameters are Llama's."""

from __future__ import annotations

from automodel_tpu_torch.models.common.state_dict import FusedTensorMixin
from automodel_tpu_torch.models.common.transformer import DenseDecoderConfig
from automodel_tpu_torch.models.llama.state_dict_adapter import LlamaStateDictAdapter

__all__ = ["Phi3StateDictAdapter"]


class Phi3StateDictAdapter(FusedTensorMixin, LlamaStateDictAdapter):
    _fused = [
        ("self_attn.qkv_proj.weight",
         ["self_attn.q_proj.weight", "self_attn.k_proj.weight", "self_attn.v_proj.weight"]),
        ("mlp.gate_up_proj.weight", ["mlp.gate_proj.weight", "mlp.up_proj.weight"]),
    ]

    def __init__(self, cfg: DenseDecoderConfig):
        super().__init__(cfg)
        q = cfg.num_attention_heads * cfg.head_dim
        kv = cfg.num_key_value_heads * cfg.head_dim
        # part sizes along HF's out_features dim 0
        self._fused_splits = {"self_attn.qkv_proj.weight": [q, kv, kv],
                              "mlp.gate_up_proj.weight": [cfg.intermediate_size] * 2}
