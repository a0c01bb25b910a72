"""Biencoder (retrieval embedding) training (counterpart of
``automodel_tpu/recipes/biencoder/train_biencoder.py``).

One shared bidirectional tower (``models/llama_bidirectional``) embeds the queries and
their passages; the loss is contrastive CE over ``q @ p.T / temperature`` with each
query's positive at a known row. The product runs in the compute dtype and is cast to
f32 after it, as JAX's (at temperature 0.02 a bf16 rounding of the scores is 50x over).
In-batch negatives and L2-normalised embeddings are on by default. Validation logs
``val_loss``, ``val_acc1``, ``val_recall_at_{k}`` and ``val_mrr``.

The YAML adds a ``biencoder`` section (``temperature``, ``normalize``,
``in_batch_negatives``, ``query_seq_len``, ``passage_seq_len``, ``recall_k``) and takes
``data/llm/retrieval.py::RetrievalDataset`` as its dataset.
"""

from __future__ import annotations

import numpy as np
import torch

from automodel_tpu_torch.config.cli_overrides import parse_args_and_load_config
from automodel_tpu_torch.config.loader import ConfigNode
from automodel_tpu_torch.data.llm.retrieval import encode_block, retrieval_collate
from automodel_tpu_torch.recipes.llm.train_ft import TrainFinetuneRecipeForNextTokenPrediction

__all__ = ["TrainBiencoderRecipe", "main", "positive_ranks"]


def positive_ranks(scores: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """1-based rank of each query's positive within its score row. Ties are broken by
    column, the first one ahead (``torch.topk``'s first-occurrence order): rank = 1 +
    the columns scoring higher + the tied columns before the positive. In-batch
    duplicates tie exactly, and counting only strict wins would rank every duplicate
    first."""
    labels = labels.long()
    pos = scores.gather(-1, labels[:, None])
    cols = torch.arange(scores.shape[-1], device=scores.device)[None, :]
    tied_before = ((scores == pos) & (cols < labels[:, None])).sum(-1)
    return 1 + (scores > pos).sum(-1) + tied_before


class TrainBiencoderRecipe(TrainFinetuneRecipeForNextTokenPrediction):
    def _biencoder(self) -> ConfigNode:
        return self.cfg.get("biencoder") or ConfigNode()

    def _wrap_dataset_and_collate(self, dataset, pad_id: int):
        bc = self._biencoder()
        q_len = int(bc.get("query_seq_len", self.seq_len))
        p_len = int(bc.get("passage_seq_len", self.seq_len))
        return dataset, (lambda exs: retrieval_collate(
            exs, tokenizer=self.tokenizer, query_seq_len=q_len, passage_seq_len=p_len,
            pad_token_id=pad_id))

    def _scores_and_labels(self, batch, params=None):
        """(scores (B, B*G) f32, already over the temperature; labels (B,)): the
        contrastive core of the train loss and of validation. The labels come from the
        batch's shape: query i's positive is row i*G of p."""
        bc = self._biencoder()
        temperature = float(bc.get("temperature", 0.02))
        q = self.model(batch["q_ids"], positions=batch["q_pos"], segment_ids=batch["q_seg"],
                       mesh=self.mesh, params=params)  # (B, D)
        p = self.model(batch["p_ids"], positions=batch["p_pos"], segment_ids=batch["p_seg"],
                       mesh=self.mesh, params=params)  # (B*G, D)
        if bool(bc.get("normalize", True)):
            q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
            p = p / torch.linalg.vector_norm(p, dim=-1, keepdim=True)
        b = q.shape[0]
        group = p.shape[0] // b
        labels = torch.arange(b, device=q.device) * group
        scores = (q @ p.T).float() / temperature
        if not bool(bc.get("in_batch_negatives", True)):
            # each query against its own passage group only
            own = (torch.arange(b * group, device=q.device)[None, :] // group
                   == torch.arange(b, device=q.device)[:, None])
            scores = scores.masked_fill(~own, float("-inf"))
        return scores, labels

    @staticmethod
    def _nll(scores, labels):
        return -torch.log_softmax(scores, dim=-1).gather(-1, labels[:, None])[:, 0]

    def _forward_loss(self, batch, num_label_tokens, training: bool = True, params=None):
        """The microbatch's summed contrastive CE over the step's query count
        (``num_label_tokens``: one label a query)."""
        scores, labels = self._scores_and_labels(batch, params)
        return self._nll(scores, labels).sum() / num_label_tokens.clamp_min(1).float()

    def _run_validation(self, step: int):
        """val_loss and the ranks of the positives: acc@1, recall@k (``recall_k``,
        default 5) and MRR, on the merged weights under PEFT (as JAX's, no QAT)."""
        recall_k = int(self._biencoder().get("recall_k", 5))
        params = None
        with torch.no_grad():
            if self.peft is not None:
                from automodel_tpu_torch.peft.lora import merge_lora_params

                params = merge_lora_params(self.params, self.train_params, self.peft)
            loss = acc1 = hits = rr = 0.0
            queries = 0
            for batch in self._iter_val_batches():
                scores, labels = self._scores_and_labels(self._to_device(batch), params)
                rank = positive_ranks(scores, labels)
                loss += float(self._nll(scores, labels).sum())
                acc1 += float((rank == 1).sum())
                hits += float((rank <= recall_k).sum())
                rr += float((1.0 / rank.float()).sum())
                queries += int(batch["q_ids"].shape[0])
        self._log_val_loss(step, loss, queries, extra_sums={
            "val_acc1": acc1, f"val_recall_at_{recall_k}": hits, "val_mrr": rr})

    def encode(self, texts: list[str], batch_size: int = 32, seq_len: int | None = None
               ) -> np.ndarray:
        """(len(texts), D) f32 embeddings of ``texts`` by the tower's own parameters
        (normalised with ``biencoder.normalize``): what mining reads."""
        bc = self._biencoder()
        seq_len = seq_len or int(bc.get("passage_seq_len", self.seq_len))
        out = []
        with torch.no_grad():
            for i in range(0, len(texts), batch_size):
                ids, seg, pos = (torch.from_numpy(a).to(self.device) for a in encode_block(
                    self.tokenizer, texts[i:i + batch_size], seq_len))
                emb = self.model(ids, positions=pos, segment_ids=seg, mesh=self.mesh)
                if bool(bc.get("normalize", True)):
                    emb = emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
                out.append(emb.float().cpu().numpy())
        return np.concatenate(out)


def main(cfg: ConfigNode | None = None, argv=None):
    if cfg is None:
        cfg = parse_args_and_load_config(argv)
    recipe = TrainBiencoderRecipe(cfg)
    recipe.setup()
    recipe.run_train_validation_loop()
    return recipe


if __name__ == "__main__":
    main()
