"""The port's host-side pieces against the JAX package's: mock data, collation,
batch order, step grouping, LR schedule, FLOPs, config loading and metric rows.
These are numpy and Python on both sides, so they must agree exactly."""

import json
import math

import numpy as np
import pytest

from automodel_tpu.config.cli_overrides import parse_args_and_load_config as jax_parse
from automodel_tpu.data.collate import sft_collate as jax_collate, stack_batches as jax_stack
from automodel_tpu.data.llm.mock import MockSFTDataset as JaxMock
from automodel_tpu.data.loader import DataLoader as JaxLoader
from automodel_tpu.optim.scheduler import build_lr_schedule as jax_schedule
from automodel_tpu.training.step_scheduler import StepScheduler as JaxScheduler
from automodel_tpu.utils.flops import flops_per_token as jax_flops
from automodel_tpu_torch.config.cli_overrides import parse_args_and_load_config
from automodel_tpu_torch.config.loader import ConfigNode, map_target, resolve_target
from automodel_tpu_torch.data.collate import sft_collate, stack_batches
from automodel_tpu_torch.data.llm.mock import MockSFTDataset
from automodel_tpu_torch.data.loader import DataLoader
from automodel_tpu_torch.loggers.metric_logger import MetricLogger
from automodel_tpu_torch.optim.scheduler import build_lr_schedule
from automodel_tpu_torch.training.step_scheduler import StepScheduler
from automodel_tpu_torch.utils.flops import flops_per_token, mfu


@pytest.mark.parametrize("pattern", ["random", "arith"])
def test_mock_dataset_identical(pattern):
    a, b = MockSFTDataset(1000, 17, 20, seed=3, pattern=pattern), JaxMock(1000, 17, 20, seed=3,
                                                                           pattern=pattern)
    assert len(a) == len(b)
    for i in range(len(a)):
        assert a[i] == b[i]


def test_collate_and_stack_identical():
    exs = [{"input_ids": list(range(10)), "prompt_len": 4},
           {"input_ids": list(range(5, 30)), "prompt_len": 0},
           {"input_ids": [1, 2, 3], "labels": [-100, 7, 8]}]
    for seq in (8, 16):
        got, want = sft_collate(exs, seq, pad_token_id=2), jax_collate(exs, seq, pad_token_id=2)
        assert got.keys() == want.keys()
        for k in got:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    bs = [sft_collate(exs[:2], 8), sft_collate(exs[1:], 8)]
    got, want = stack_batches(bs), jax_stack(bs)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))


def test_loader_and_scheduler_order_identical():
    ds = MockSFTDataset(50, 6, 22, seed=1)
    collate = lambda exs: sft_collate(exs, 6)  # noqa: E731
    ours = StepScheduler(grad_acc_steps=3, num_epochs=2,
                         dataloader=DataLoader(ds, 4, collate, seed=5))
    theirs = JaxScheduler(grad_acc_steps=3, num_epochs=2, handle_sigterm=False,
                          dataloader=JaxLoader(JaxMock(50, 6, 22, seed=1), 4, collate, seed=5))
    got, want = list(ours), list(theirs)
    assert [len(g) for g in got] == [len(w) for w in want] == [3, 2, 3, 2]
    for g, w in zip(got, want):
        for gb, wb in zip(g, w):
            np.testing.assert_array_equal(gb["input_ids"], wb["input_ids"])
    assert ours.step == theirs.step and ours.done


@pytest.mark.parametrize("style", ["cosine", "linear", "constant"])
def test_lr_schedule_identical(style):
    kw = dict(max_lr=3e-4, min_lr=3e-5, init_lr=1e-6, lr_warmup_steps=5, lr_decay_steps=40,
              lr_decay_style=style)
    ours, theirs = build_lr_schedule(**kw), jax_schedule(**kw)
    for step in range(0, 50, 3):
        assert ours(step) == pytest.approx(float(theirs(step)), rel=1e-6)


def test_flops_and_mfu():
    cfg = dict(hidden_size=2048, num_hidden_layers=16, vocab_size=128256,
               intermediate_size=8192, num_attention_heads=32, num_key_value_heads=8,
               head_dim=64)
    assert flops_per_token(cfg, 2048) == jax_flops(cfg, 2048)
    assert mfu(500.0, 989e9, "NVIDIA H100 80GB HBM3") == pytest.approx(0.5)
    assert mfu(1000.0, 989e9, "cpu") is None
    with pytest.raises(NotImplementedError):
        flops_per_token(dict(cfg, num_experts=8), 2048)


def test_config_and_overrides_match(tmp_path):
    p = tmp_path / "c.yaml"
    p.write_text("a:\n  b: 1\n  c: [1, 2]\nname: x\n")
    argv = ["-c", str(p), "--a.b", "3", "--a.d=true", "--new.key", "null", "--flag"]
    assert parse_args_and_load_config(argv).to_dict() == jax_parse(argv).to_dict()


def test_target_maps_to_the_port():
    node = ConfigNode({"_target_": "automodel_tpu.data.llm.mock.MockSFTDataset",
                       "vocab_size": 10, "seq_len": 4, "num_samples": 2})
    assert type(node.instantiate()) is MockSFTDataset
    assert map_target("automodel_tpu.x:y") == "automodel_tpu_torch.x.y"
    assert map_target("automodel_tpu_torch.x") == "automodel_tpu_torch.x"
    assert resolve_target("math.sqrt") is math.sqrt
    with pytest.raises(ImportError, match="does not provide yet"):
        resolve_target("automodel_tpu.data.llm.hellaswag.HellaSwag")


def test_metric_logger_rows(tmp_path):
    path = tmp_path / "training.jsonl"
    log = MetricLogger(path)
    log.log_header(device_kind="cpu")
    log.log(1, loss=float("nan"), tps=12.3456789)
    log.close()
    rows = [json.loads(x) for x in path.read_text().splitlines()]
    assert rows[0]["run_header"] is True
    assert rows[1]["loss"] is None and rows[1]["loss_nonfinite"] is True
    assert rows[1]["tps"] == 12.345679
