"""GLM-4 dense and GLM (counterpart of ``automodel_tpu/models/glm4/model.py``): the Llama
decoder with interleaved RoPE over the first half of head_dim, GLM-4's sandwich norms
(``LlamaConfig.from_hf`` reads both from the architecture's name), and HF's fused
``mlp.gate_up_proj`` tensor, split and fused again by the adapter."""

from __future__ import annotations

from automodel_tpu_torch.models.llama.model import LlamaForCausalLM

__all__ = ["Glm4ForCausalLM"]


class Glm4ForCausalLM(LlamaForCausalLM):
    """GLM-4 / GLM: Llama's parameters and forward, GLM's adapter."""

    def state_dict_adapter(self):
        from automodel_tpu_torch.models.glm4.state_dict_adapter import Glm4StateDictAdapter

        return Glm4StateDictAdapter(self.config)
