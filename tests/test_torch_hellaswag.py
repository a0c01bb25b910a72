"""The port's HellaSwag data path against the JAX package's: the same rows give the same
input_ids and prompt_len, and the same collated batches, for a stub tokenizer and for
a tiny word-level tokenizer built in tmp with ``tokenizers`` and loaded through each
package's AutoTokenizer (BOS enforced); train_ft builds the tokenizer from
``tokenizer._target_`` or from the model's HF directory."""

import json

import numpy as np
import pytest

from automodel_tpu.data.collate import sft_collate as jax_collate
from automodel_tpu.data.llm.hellaswag import HellaSwagDataset as JaxHellaSwag
from automodel_tpu.data.tokenize import tokenize_sft_example as jax_tokenize
from automodel_tpu.models.auto_tokenizer import AutoTokenizer as JaxAutoTokenizer
from automodel_tpu_torch.config.cli_overrides import parse_args_and_load_config
from automodel_tpu_torch.data.collate import sft_collate
from automodel_tpu_torch.data.llm.hellaswag import HellaSwagDataset
from automodel_tpu_torch.data.tokenize import tokenize_sft_example
from automodel_tpu_torch.models.auto_tokenizer import AutoTokenizer
from automodel_tpu_torch.recipes.llm import train_ft
from tests.torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

WORDS = "a man is sitting on roof he starts pulling up shingles then walks away the woman".split()


class StubTokenizer:
    """One id per whitespace word, EOS appended by the tokenization helper."""

    eos_token_id, pad_token_id = 1, 0

    def encode(self, text):
        return [2 + WORDS.index(w) if w in WORDS else 2 + len(WORDS) for w in text.split()]


def _rows(path, n=12, seed=0):
    rng = np.random.RandomState(seed)
    with open(path, "w") as f:
        for _ in range(n):
            f.write(json.dumps({"ctx": " ".join(rng.choice(WORDS, rng.randint(3, 9))),
                                "endings": [" ".join(rng.choice(WORDS, rng.randint(1, 5)))
                                            for _ in range(4)],
                                "label": str(rng.randint(4))}) + "\n")
    return str(path)


def _word_level_dir(tmp_path):
    from tokenizers import Tokenizer, models, pre_tokenizers

    vocab = {t: i for i, t in enumerate(["[PAD]", "<s>", "</s>", "[UNK]", *WORDS])}
    tok = Tokenizer(models.WordLevel(vocab, unk_token="[UNK]"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    d = tmp_path / "tok"
    d.mkdir()
    tok.save(str(d / "tokenizer.json"))
    (d / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "PreTrainedTokenizerFast", "bos_token": "<s>", "eos_token": "</s>",
        "pad_token": "[PAD]", "unk_token": "[UNK]"}))
    return str(d)


@pytest.mark.parametrize("tokenizer", ["stub", "word_level"])
def test_same_examples_and_batches_as_jax(tmp_path, tokenizer):
    path = _rows(tmp_path / "rows.jsonl")
    if tokenizer == "stub":
        ours = theirs = StubTokenizer()
    else:
        d = _word_level_dir(tmp_path)
        ours, theirs = AutoTokenizer.from_pretrained(d), JaxAutoTokenizer.from_pretrained(d)
        assert ours.encode("a man")[0] == ours.bos_token_id == 1
    got = HellaSwagDataset(path_or_dataset_id=path, tokenizer=ours, limit_dataset_samples=10)
    want = JaxHellaSwag(path_or_dataset_id=path, tokenizer=theirs, limit_dataset_samples=10)
    assert len(got) == len(want) == 10
    for i in range(len(got)):
        assert got[i] == want[i]
        assert got[i]["input_ids"][-1] == ours.eos_token_id
    assert tokenize_sft_example(ours, "a man", "walks") == jax_tokenize(theirs, "a man", "walks")
    a = sft_collate([got[i] for i in range(4)], seq_len=24, pad_token_id=0)
    b = jax_collate([want[i] for i in range(4)], seq_len=24, pad_token_id=0)
    for k in b:
        np.testing.assert_array_equal(a[k], np.asarray(b[k]), err_msg=k)


TINY = """
device: cpu
model:
  config: {architectures: [LlamaForCausalLM], vocab_size: 64, hidden_size: 32,
           intermediate_size: 64, num_hidden_layers: 1, num_attention_heads: 2,
           num_key_value_heads: 1}
dataset: {_target_: automodel_tpu.data.llm.hellaswag.HellaSwagDataset}
micro_batch_size: 2
seq_len: 32
checkpoint: {enabled: false}
"""


@pytest.mark.parametrize("source", ["hf_dir", "target"])
def test_train_ft_builds_the_tokenizer(tmp_path, source):
    (tmp_path / "tiny.yaml").write_text(TINY)
    args = ["-c", str(tmp_path / "tiny.yaml"), "--output_dir", str(tmp_path / "run"),
            "--dataset.path_or_dataset_id", _rows(tmp_path / "rows.jsonl", n=16)]
    if source == "hf_dir":
        args += ["--tokenizer.pretrained_model_name_or_path", _word_level_dir(tmp_path)]
    else:
        args += ["--tokenizer._target_", "tests.test_torch_hellaswag.StubTokenizer"]
    recipe = train_ft.TrainFinetuneRecipeForNextTokenPrediction(parse_args_and_load_config(args))
    recipe.setup()
    if source == "hf_dir":
        assert recipe.tokenizer.encode("a man") == [1, 4, 5]
    else:
        assert isinstance(recipe.tokenizer, StubTokenizer)
    batch = next(iter(recipe.dataloader))
    assert batch["input_ids"].shape == (2, 32) and (batch["labels"] != -100).any()
    assert batch["input_ids"].max() < 64


def test_unported_tokenizers_and_hub_ids_raise(tmp_path):
    d = tmp_path / "mistral"
    d.mkdir()
    (d / "tekken.json").write_text("{}")
    with pytest.raises(NotImplementedError, match="mistral"):
        AutoTokenizer.from_pretrained(str(d))
    with pytest.raises(NotImplementedError, match="hub"):
        AutoTokenizer.from_pretrained("meta-llama/Llama-3.2-1B")
