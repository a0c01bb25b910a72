"""Sequence-classification fine-tuning (counterpart of
``automodel_tpu/recipes/llm/train_seq_cls.py``).

``train_ft``'s recipe with a classification head (``models/seq_cls.py``: the decoder's
LM head dropped, ``score`` on the last real token), class-label collation
(``data/llm/seq_cls.py``) and softmax cross entropy over ``model.num_labels``: a loss
per example, divided by the step's example count (the counterpart of the token-count
normalisation). As in JAX, the parameters are f32 whatever ``model.params_dtype`` says,
and under ``peft`` the adapter alone trains: the head stays at its init.
"""

from __future__ import annotations

import torch

from automodel_tpu_torch.config.cli_overrides import parse_args_and_load_config
from automodel_tpu_torch.config.loader import ConfigNode
from automodel_tpu_torch.data.llm.seq_cls import seq_cls_collate
from automodel_tpu_torch.models.seq_cls import AutoModelForSequenceClassification
from automodel_tpu_torch.recipes.llm.train_ft import TrainFinetuneRecipeForNextTokenPrediction

__all__ = ["TrainSeqClsRecipe", "main"]


class TrainSeqClsRecipe(TrainFinetuneRecipeForNextTokenPrediction):
    auto_model = AutoModelForSequenceClassification

    def _params_dtype(self) -> torch.dtype:
        return torch.float32  # as JAX's, whatever model.params_dtype says

    def _auto_model_kwargs(self) -> dict:
        return {"num_labels": int(self.cfg.get("model.num_labels", 2))}

    def _wrap_dataset_and_collate(self, dataset, pad_id: int):
        return dataset, (lambda exs: seq_cls_collate(exs, seq_len=self.seq_len,
                                                     pad_token_id=pad_id))

    def _forward_loss(self, batch, num_label_tokens, training: bool = True, params=None):
        """The microbatch's summed CE over the classes, divided by the step's example
        count (``num_label_tokens``: every class label counts, none is ignored)."""
        logits = self.model(batch["input_ids"], positions=batch["positions"],
                            segment_ids=batch["segment_ids"], mesh=self.mesh, params=params)
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -logp.gather(-1, batch["labels"].long()[:, None])[:, 0]
        return nll.sum() / num_label_tokens.clamp_min(1).float()


def main(cfg: ConfigNode | None = None, argv=None):
    if cfg is None:
        cfg = parse_args_and_load_config(argv)
    recipe = TrainSeqClsRecipe(cfg)
    recipe.setup()
    recipe.run_train_validation_loop()
    return recipe


if __name__ == "__main__":
    main()
