"""The HF PEFT adapter export: ``adapter_model.safetensors`` and ``adapter_config.json``
in the layout the ``peft`` library loads (counterpart of
``automodel_tpu/checkpoint/peft_export.py``).

Names follow the model's state-dict Entry table: an adapter ``layers.wq`` takes the HF
module of the single-key Entry of ``layers.wq`` (``model.layers.{i}.self_attn.q_proj``),
one tensor pair a layer (``layer_range`` gives the HF layer ids), transposed to torch
``Linear`` layout: ``lora_A.weight`` (r, in_features), ``lora_B.weight`` (out_features,
r), and DoRA's ``lora_magnitude_vector`` (out_features,). Weights whose Entry merges
several HF tensors (a fused qkv) or that stack experts are skipped with a warning, as
the JAX package skips them.
"""

from __future__ import annotations

import json
import logging
import os

import torch

from automodel_tpu_torch.checkpoint.safetensors_io import _write_file
from automodel_tpu_torch.peft.lora import group_lora

logger = logging.getLogger(__name__)

__all__ = ["save_peft_adapter"]


def save_peft_adapter(out_dir: str, lora: dict[str, torch.Tensor], peft_cfg, entries,
                      base_model_name: str | None = None) -> None:
    """Write the adapter directory."""
    by_ours = {e.ours: e for e in entries if isinstance(e.hf, str)}
    tensors: dict[str, torch.Tensor] = {}
    modules: set[str] = set()
    for path, leaf in group_lora(lora).items():
        e = by_ours.get(path)
        if e is None:
            logger.warning("peft export: no single-key HF mapping for %r (merged/tuple "
                           "entries can't split a low-rank delta) - skipped", path)
            continue
        module_tmpl = e.hf.removesuffix(".weight")
        a, b = leaf["lora_a"].detach().cpu(), leaf["lora_b"].detach().cpu()
        mag = leaf["magnitude"].detach().cpu() if "magnitude" in leaf else None
        n_stack = a.ndim - 2
        if n_stack >= 1:
            hf_ids = list(e.layer_range if e.layer_range is not None else range(a.shape[0]))
        else:
            hf_ids = [None]
        for li, i in enumerate(hf_ids):
            a_l = a[li] if i is not None else a
            b_l = b[li] if i is not None else b
            if a_l.ndim != 2:  # expert-stacked adapters
                logger.warning("peft export: %r has extra stack dims - skipped", path)
                break
            module = module_tmpl.format(i=i) if i is not None else module_tmpl
            modules.add(module.rsplit(".", 1)[-1])
            key = f"base_model.model.{module}"
            tensors[f"{key}.lora_A.weight"] = a_l.T.contiguous()
            tensors[f"{key}.lora_B.weight"] = b_l.T.contiguous()
            if mag is not None:
                tensors[f"{key}.lora_magnitude_vector"] = (
                    mag[li] if i is not None else mag).contiguous()
    os.makedirs(out_dir, exist_ok=True)
    _write_file(os.path.join(out_dir, "adapter_model.safetensors"), tensors, {"format": "pt"})
    cfg = {
        "peft_type": "LORA",
        "r": int(peft_cfg.dim),
        "lora_alpha": int(peft_cfg.alpha),
        "lora_dropout": float(peft_cfg.dropout),
        "use_dora": bool(peft_cfg.use_dora),
        "target_modules": sorted(modules),
        "bias": "none",
        "task_type": "CAUSAL_LM",
        "base_model_name_or_path": base_model_name or "",
        "use_rslora": False,  # the scaling is alpha / r
    }
    with open(os.path.join(out_dir, "adapter_config.json"), "w") as f:
        json.dump(cfg, f, indent=2)
