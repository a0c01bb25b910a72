"""GLM-4 HF key mapping (counterpart of ``automodel_tpu/models/glm4/state_dict_adapter.py``):
Llama's table, the sandwich norms among it, with HF's fused ``mlp.gate_up_proj.weight``
(gate | up) split into the table's gate / up keys on the way in and fused again on the
way out (``to_hf`` and ``to_hf_lazy``)."""

from __future__ import annotations

from automodel_tpu_torch.models.common.state_dict import FusedTensorMixin
from automodel_tpu_torch.models.common.transformer import DenseDecoderConfig
from automodel_tpu_torch.models.llama.state_dict_adapter import LlamaStateDictAdapter

__all__ = ["Glm4StateDictAdapter"]


class Glm4StateDictAdapter(FusedTensorMixin, LlamaStateDictAdapter):
    _fused = [("mlp.gate_up_proj.weight", ["mlp.gate_proj.weight", "mlp.up_proj.weight"])]

    def __init__(self, cfg: DenseDecoderConfig):
        super().__init__(cfg)
        # part sizes along HF's out_features dim 0
        self._fused_splits = {"mlp.gate_up_proj.weight": [cfg.intermediate_size] * 2}
