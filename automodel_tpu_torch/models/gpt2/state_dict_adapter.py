"""GPT-2's HF key mapping (counterpart of ``automodel_tpu/models/gpt2/state_dict_adapter.py``).

HF's Conv1D weights are stored (in, out), the port's orientation, so every transform is
the identity: only the ``transformer.`` names and the layer stacking differ. HF's
``attn.bias`` / ``attn.masked_bias`` buffers (the causal mask of older checkpoints) and
its tied ``lm_head.weight`` are not parameters here: they are read by no entry and
written by none.
"""

from __future__ import annotations

from automodel_tpu_torch.models.common.state_dict import Entry, MappingAdapter

__all__ = ["GPT2StateDictAdapter"]


class GPT2StateDictAdapter(MappingAdapter):
    def __init__(self, cfg):
        pre = "transformer.h.{i}"
        entries = [
            Entry("transformer.wte.weight", "wte"),
            Entry("transformer.wpe.weight", "wpe"),
            Entry("transformer.ln_f.weight", "lnf_w"),
            Entry("transformer.ln_f.bias", "lnf_b"),
            Entry(f"{pre}.ln_1.weight", "layers.ln1_w"),
            Entry(f"{pre}.ln_1.bias", "layers.ln1_b"),
            Entry(f"{pre}.attn.c_attn.weight", "layers.c_attn"),
            Entry(f"{pre}.attn.c_attn.bias", "layers.c_attn_b"),
            Entry(f"{pre}.attn.c_proj.weight", "layers.c_proj"),
            Entry(f"{pre}.attn.c_proj.bias", "layers.c_proj_b"),
            Entry(f"{pre}.ln_2.weight", "layers.ln2_w"),
            Entry(f"{pre}.ln_2.bias", "layers.ln2_b"),
            Entry(f"{pre}.mlp.c_fc.weight", "layers.c_fc"),
            Entry(f"{pre}.mlp.c_fc.bias", "layers.c_fc_b"),
            Entry(f"{pre}.mlp.c_proj.weight", "layers.c_proj2"),
            Entry(f"{pre}.mlp.c_proj.bias", "layers.c_proj2_b"),
        ]
        super().__init__(entries, cfg.n_layer)
