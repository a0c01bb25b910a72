"""The port's biencoder against the JAX package's: the bidirectional tower (a tiny
Llama trunk, f32: pooled embeddings and every gradient within 1e-4 under each pooling,
on the flash path, JAX's Pallas kernel in interpret mode against the kernels' plain
version, non-causal with right padding, and on the einsum path), positive_ranks with
ties, the retrieval dataset and collation, three train_biencoder steps with validation
(losses and retrieval metrics within 1e-4) given JAX's initial weights, and hard-negative
mining, which gives JAX's negatives on the same weights and rows."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automodel_tpu.config.loader import load_config as jax_load_config
from automodel_tpu.data.llm import retrieval as jax_retrieval
from automodel_tpu.models.common.backend import BackendConfig as JaxBackend
from automodel_tpu.models.llama_bidirectional.model import (
    LlamaBidirectionalModel as JaxBidirectional)
from automodel_tpu.recipes.biencoder import mine_hard_negatives as jax_mining
from automodel_tpu.recipes.biencoder import train_biencoder as jax_biencoder
from automodel_tpu_torch.data.llm import retrieval
from automodel_tpu_torch.models.auto import AutoModelForCausalLM
from automodel_tpu_torch.models.common.backend import BackendConfig
from automodel_tpu_torch.models.llama.convert import flatten, params_from_jax
from automodel_tpu_torch.models.llama_bidirectional import (
    LlamaBidirectionalConfig, LlamaBidirectionalModel, pool_hidden)
from automodel_tpu_torch.recipes.biencoder import mine_hard_negatives, train_biencoder
from tests.torch_threads import one_intra_op_thread  # noqa: F401 (autouse)
from tests.unit.test_datasets_llm import WordTokenizer

HF = dict(architectures=["LlamaBidirectionalModel"], vocab_size=128, hidden_size=32,
          intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
          num_key_value_heads=2, max_position_embeddings=64)
ATTENTION = {"flash": ("flash_interpret", "flash"), "xla": ("xla", "xla")}


def _batch(b=3, s=16, seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(3, 128, (b, s)).astype(np.int32)
    seg = np.zeros((b, s), np.int32)
    for r, n in enumerate((s, 9, 1)[:b]):  # a full row, a padded one, one token
        seg[r, :n] = 1
    pos = np.where(seg > 0, np.arange(s)[None], 0).astype(np.int32)
    return ids, pos, seg


@pytest.mark.parametrize("attention", list(ATTENTION))
@pytest.mark.parametrize("pooling", ["avg", "cls", "last"])
def test_pooled_embeddings_and_grads_match_jax(pooling, attention):
    hf = dict(HF, pooling=pooling)
    jax_attention, port_attention = ATTENTION[attention]
    jm = JaxBidirectional.from_config(hf, JaxBackend(dtype="float32", attention=jax_attention))
    params = jax.device_get(jm.init(jax.random.key(0)))
    ids, pos, seg = _batch()
    ct = np.random.RandomState(1).randn(3, 32).astype(np.float32)

    def jax_loss(p):
        emb = jm(p, jnp.asarray(ids), positions=jnp.asarray(pos), segment_ids=jnp.asarray(seg))
        return jnp.sum(emb * ct), emb

    (_, want), jgrads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(params)
    model = AutoModelForCausalLM.from_config(
        hf, BackendConfig(dtype="float32", attention=port_attention), device="cpu")
    assert isinstance(model, LlamaBidirectionalModel) and not model.config.causal
    assert "lm_head" not in model.param_dict()
    model.load_params(params_from_jax(params, model.config))
    weights = model.param_dict()
    emb = model(torch.from_numpy(ids), positions=torch.from_numpy(pos),
                segment_ids=torch.from_numpy(seg))
    grads = torch.autograd.grad((emb * torch.from_numpy(ct)).sum(), list(weights.values()))
    np.testing.assert_allclose(emb.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    jflat = flatten(jax.device_get(jgrads))
    for name, g in zip(weights, grads):
        np.testing.assert_allclose(g.numpy(), jflat[name], rtol=1e-4, atol=1e-4, err_msg=name)


def test_attention_is_bidirectional_and_pooling_refuses_unknown():
    model = AutoModelForCausalLM.from_config(HF, BackendConfig(dtype="float32"), device="cpu")
    ids = torch.arange(10).reshape(1, 10)
    h1 = model(ids, pooled=False)
    h2 = model(torch.where(torch.arange(10) == 8, ids + 1, ids), pooled=False)
    assert (h1[0, 0] - h2[0, 0]).abs().max() > 1e-6  # a later token moves the first
    with pytest.raises(ValueError, match="avg | cls | last"):
        pool_hidden(h1, torch.ones(1, 10, dtype=torch.bool), "max")


def test_tower_temperature_is_refused_for_the_recipes():
    """The loss reads biencoder.temperature; a tower's own one (JAX's field, read by
    nothing) raises, HF's serialised default 1.0 passes."""
    assert not hasattr(LlamaBidirectionalConfig.from_hf(dict(HF, temperature=1.0)),
                       "temperature")
    with pytest.raises(ValueError, match="biencoder.temperature"):
        LlamaBidirectionalConfig.from_hf(dict(HF, temperature=0.02))


@pytest.mark.parametrize("case", ["distinct", "ties", "all_tied", "random"])
def test_positive_ranks_match_jax(case):
    """Ties break by column, the first one ahead: rank 1 + higher scores + tied columns
    before the positive."""
    rng = np.random.default_rng(0)
    scores, labels = {
        "distinct": ([[0.1, 0.9, 0.5], [0.7, 0.2, 0.3]], [1, 2]),
        "ties": ([[1.0, 0.5, 1.0, 1.0]] * 3, [2, 0, 3]),
        "all_tied": (np.zeros((4, 4)), [0, 1, 2, 3]),
        "random": (rng.choice([0.0, 0.25, 0.5, 1.0], size=(16, 12)),
                   rng.integers(0, 12, size=16)),
    }[case]
    scores = np.asarray(scores, np.float32)
    labels = np.asarray(labels, np.int32)
    got = train_biencoder.positive_ranks(torch.from_numpy(scores), torch.from_numpy(labels))
    want = jax_biencoder.positive_ranks(jnp.asarray(scores), jnp.asarray(labels))
    assert got.tolist() == np.asarray(want).tolist()
    order = np.argsort(-scores, axis=-1, kind="stable")  # stable: first occurrence first
    assert got.tolist() == [int(np.where(order[i] == labels[i])[0][0]) + 1
                            for i in range(len(labels))]


def _pairs(tmp_path, n=32, negs=0):
    """Rows without negatives, or with ``negs`` + (0, 1, 2, 3) of them in turn (with
    ``negs`` 0: none, fewer than asked and more)."""
    rows = [{"query": f"qword{i}", "pos_doc": f"dword{i} extra{i}"} for i in range(n)]
    if negs is not None:
        for i, r in enumerate(rows):
            r["neg_doc"] = [f"dword{(i + j) % n}" for j in range(1, 1 + negs + i % 4)]
    p = tmp_path / f"rows{negs}.jsonl"
    p.write_text("\n".join(json.dumps(r) for r in rows))
    return str(p)


@pytest.mark.parametrize("k", [0, 1, 2])
def test_retrieval_dataset_and_collate_match_jax(k, tmp_path):
    path, tok = _pairs(tmp_path, 8), WordTokenizer()
    kw = dict(num_hard_negatives=k, query_prefix="query: ", passage_prefix="passage: ")
    ours = retrieval.RetrievalDataset(path, tok, **kw)
    theirs = jax_retrieval.RetrievalDataset(path, tok, **kw)
    exs = [ours[i] for i in range(8)]
    assert exs == [theirs[i] for i in range(8)]
    got = retrieval.retrieval_collate(exs, tok, 4, 3, pad_token_id=2)
    want = jax_retrieval.retrieval_collate(exs, tok, 4, 3, pad_token_id=2)
    assert got.keys() == want.keys()
    for key in got:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    retrieval.write_retrieval_jsonl(ours.rows, str(tmp_path / "out" / "rows.jsonl"))
    assert retrieval.RetrievalDataset(str(tmp_path / "out" / "rows.jsonl")).rows == ours.rows


RECIPE = """
seed: 7
device: cpu
output_dir: {out}
model:
  config:
    architectures: [LlamaBidirectionalModel]
    vocab_size: 1024
    hidden_size: 32
    intermediate_size: 64
    num_hidden_layers: 2
    num_attention_heads: 4
    num_key_value_heads: 2
    max_position_embeddings: 64
    pooling: {pooling}
distributed:
  dp_shard: -1
backend:
  dtype: float32
  attention: flash
biencoder:
  temperature: 0.1
  query_seq_len: 8
  passage_seq_len: 8
  recall_k: 3
  in_batch_negatives: {in_batch}
tokenizer:
  _target_: tests.unit.test_datasets_llm.WordTokenizer
dataset:
  _target_: automodel_tpu.data.llm.retrieval.RetrievalDataset
  path_or_dataset_id: {train}
  num_hard_negatives: 1
validation_dataset:
  _target_: automodel_tpu.data.llm.retrieval.RetrievalDataset
  path_or_dataset_id: {mined}
  num_hard_negatives: 2
validation_max_batches: 2
micro_batch_size: 8
seq_len: 8
step_scheduler:
  grad_acc_steps: 2
  max_steps: 3
  num_epochs: 20
  val_every_steps: 2
optimizer:
  lr: 5.0e-3
  weight_decay: 0.01
  max_grad_norm: 1.0
lr_scheduler:
  lr_warmup_steps: 1
checkpoint:
  enabled: false
mine:
  input: {pairs}
  output: {out}/mined.jsonl
  num_negatives: 3
  margin: {margin}
  margin_type: {margin_type}
  query_prefix: "query: "
  passage_prefix: "passage: "
"""


def _config(tmp_path, pooling="last", in_batch="true", margin=0.95, margin_type="perc"):
    p = tmp_path / "cfg.yaml"
    # every training row has a hard negative: a positive repeated in its own group
    # ties exactly, its gradients cancel to rounding noise, and Adam scales that noise
    # up to full steps, which no two implementations share
    p.write_text(RECIPE.format(out=tmp_path / "jax", pooling=pooling, in_batch=in_batch,
                               pairs=_pairs(tmp_path, negs=None), train=_pairs(tmp_path, negs=1),
                               mined=_pairs(tmp_path), margin=margin,
                               margin_type=margin_type))
    return str(p)


def _rows(path):
    with open(path) as f:
        return [r for r in map(json.loads, f) if "run_header" not in r]


def _carried(monkeypatch, params):
    """The port's recipe class, set up on the JAX recipe's initial weights."""
    Recipe = train_biencoder.TrainBiencoderRecipe
    build = Recipe._build_peft

    def carried(self):
        self.model.load_params(params_from_jax(params, self.model.config))
        build(self)

    monkeypatch.setattr(Recipe, "_build_peft", carried)


@pytest.mark.parametrize("pooling,in_batch", [("last", "true"), ("avg", "false")])
def test_train_biencoder_matches_jax(pooling, in_batch, tmp_path, monkeypatch):
    """Three steps of 2 microbatches of 8 queries (1 hard negative each, in-batch
    negatives on and off), validation at step 2 over 2 batches of mined rows (2 negatives
    a query): per-step losses, val_loss, val_acc1, val_recall_at_3 and val_mrr within
    1e-4 of JAX's."""
    cfg_path = _config(tmp_path, pooling, in_batch)
    jax_recipe = jax_biencoder.TrainBiencoderRecipe(jax_load_config(cfg_path))
    jax_recipe.setup()
    params = jax.device_get(jax_recipe.params)
    jax_recipe.run_train_validation_loop()
    _carried(monkeypatch, params)
    port = train_biencoder.main(argv=["-c", cfg_path, "--output_dir", str(tmp_path / "port")])
    for name in ("training", "validation"):
        want = _rows(tmp_path / "jax" / f"{name}.jsonl")
        got = _rows(tmp_path / "port" / f"{name}.jsonl")
        keys = ("loss",) if name == "training" else ("val_loss", "val_acc1", "val_recall_at_3",
                                                     "val_mrr")
        want = [[r[k] for k in keys] for r in want if keys[0] in r]
        got = [[r[k] for k in keys] for r in got if keys[0] in r]
        assert len(got) == len(want) == (3 if name == "training" else 1)
        np.testing.assert_allclose(got, want, atol=1e-4)
    rows = _rows(tmp_path / "port" / "training.jsonl")
    assert rows[0]["num_label_tokens"] == 16 and rows[0]["tps"] > 0
    assert port.loss_name == "masked_ce"


@pytest.mark.parametrize("margin,margin_type", [(0.95, "perc"), (0.0, "abs")])
def test_mining_gives_jax_negatives(margin, margin_type, tmp_path, monkeypatch):
    """mine_hard_negatives' main (the config's mine section: prefixes, the margin cut) on
    the same weights and rows gives JAX's negatives row for row; none is the positive,
    and the written rows read back through RetrievalDataset."""
    cfg_path = _config(tmp_path, margin=margin, margin_type=margin_type)
    cfg = jax_load_config(cfg_path)
    jax_recipe = jax_biencoder.TrainBiencoderRecipe(cfg)
    jax_recipe.setup()
    params = jax.device_get(jax_recipe.params)
    rows = [json.loads(line) for line in open(cfg.mine.input)]
    want = jax_mining.mine_hard_negatives(
        jax_recipe, rows, num_negatives=3, margin=margin, margin_type=margin_type,
        query_chunk=16, query_prefix="query: ", passage_prefix="passage: ")
    _carried(monkeypatch, params)
    got = mine_hard_negatives.main(argv=["-c", cfg_path, "--output_dir", str(tmp_path / "p")])
    assert got == want
    assert all(r["pos_doc"] not in r["neg_doc"] and len(r["neg_doc"]) <= 3 for r in got)
    assert sum(map(len, (r["neg_doc"] for r in got))) > 0
    back = retrieval.RetrievalDataset(str(tmp_path / "jax" / "mined.jsonl"),
                                      num_hard_negatives=3)
    assert back.rows == got
    with pytest.raises(ValueError, match="perc|abs"):
        mine_hard_negatives.mine_hard_negatives(None, rows, margin_type="relative")


def test_noncausal_launches_are_counted_apart(monkeypatch):
    """The tower's non-causal flash calls reach all three entry points with causal 0 and
    the segment ids of its right padding, and are counted in NONCAUSAL_LAUNCHES; a causal
    call is not."""
    from automodel_tpu_torch.kernels import build
    from automodel_tpu_torch.ops import flash_attention as tfa

    seen = {}

    def launch(source, name, device, *args):
        assert len(args) + 1 == len(build.SOURCES[source][name]), name
        seen[name] = args

    monkeypatch.setattr(build, "launch", launch)
    monkeypatch.setattr(tfa, "_check_cuda", lambda *a: None)  # CPU tensors stand in
    rng = np.random.RandomState(0)
    q, k, v, do = (torch.tensor(rng.randn(2, 64, n, 64)).to(torch.bfloat16).requires_grad_()
                   for n in (8, 2, 2, 8))
    seg = torch.tensor(_batch(2, 64)[2])
    for causal in (False, True):
        before, before_n = dict(tfa.LAUNCHES), dict(tfa.NONCAUSAL_LAUNCHES)
        o, _ = tfa.flash_attention_cuda(q, k, v, causal=causal, segment_ids_q=seg)
        torch.autograd.grad(o, (q, k, v), do)
        assert {n: tfa.LAUNCHES[n] - before[n] for n in before} == dict.fromkeys(before, 1)
        assert {n: tfa.NONCAUSAL_LAUNCHES[n] - before_n[n] for n in before_n} == dict.fromkeys(
            before_n, int(not causal))
        for name, args in seen.items():
            assert args[3] is not None and args[-3] == int(causal), name
