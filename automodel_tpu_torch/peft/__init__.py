from automodel_tpu_torch.peft.lora import (PeftConfig, count_lora_params, group_lora,
                                             init_lora_params, lora_merged_loss,
                                             match_lora_paths, merge_lora_params,
                                             wildcard_match)

__all__ = ["PeftConfig", "count_lora_params", "group_lora", "init_lora_params",
           "lora_merged_loss", "match_lora_paths", "merge_lora_params", "wildcard_match"]
