"""The port's Checkpointer (one process) in the cases of tests/unit/test_checkpointing.py
that apply to one process: a bitwise round trip in place, the save layout, a torn step
(marker still present), a corrupt step walked back past, keep_last_k, the latest
symlink, non-numeric step directories, best tracking, a changed model, a changed mesh
and asynchronous saves. Then train_ft: a run resumed from a checkpoint continues the
uninterrupted run's loss trajectory bitwise (f32, CPU), with and without prefetch."""

import json
import os
import shutil
import textwrap

import numpy as np
import pytest
import torch

from automodel_tpu_torch.checkpoint.checkpointing import (Checkpointer, CheckpointingConfig,
                                                          ModelSignatureMismatch, flatten_state)
from automodel_tpu_torch.checkpoint.manifest import SAVING_MARKER, verify_manifest
from automodel_tpu_torch.checkpoint.reshard import build_topology, mesh_delta, read_topology
from automodel_tpu_torch.config.cli_overrides import parse_args_and_load_config
from automodel_tpu_torch.parallel.mesh import MeshContext
from automodel_tpu_torch.recipes.llm import train_ft


def _state(seed):
    g = torch.Generator().manual_seed(seed)
    params = {"embed": torch.nn.Parameter(torch.randn(8, 4, generator=g)),
              "layers.wq": torch.nn.Parameter(torch.randn(2, 4, 2, 2, generator=g)),
              "norm": torch.randn(4, generator=g).to(torch.bfloat16)}
    opt = [{"count": torch.tensor(seed, dtype=torch.int32)},
           {"mu": {k: torch.randn(v.shape, generator=g) for k, v in params.items()}}]
    return params, opt


def _ckptr(root, **kw) -> Checkpointer:
    return Checkpointer(CheckpointingConfig(checkpoint_dir=str(root), **kw))


def _equal(a, b) -> bool:
    fa, fb = flatten_state(a), flatten_state(b)
    return set(fa) == set(fb) and all(torch.equal(fa[k], fb[k]) for k in fa)


def test_round_trip_in_place(tmp_path):
    params, opt = _state(1)
    ck = _ckptr(tmp_path)
    ck.topology = build_topology(MeshContext())
    d = ck.save(3, params, opt, client_states={"step_scheduler": {"step": 3, "epoch": 0}})
    assert sorted(os.listdir(d)) == ["client.json", "manifest.json", "model", "optim",
                                     "signature.json"]
    assert verify_manifest(d) == [] and os.readlink(tmp_path / "latest") == "step_3"
    assert read_topology(d) == ck.topology
    target, target_opt = _state(2)
    live = target["embed"]
    client, step = ck.load_latest_verified(target, target_opt)
    assert step == 3 and client == {"step_scheduler": {"step": 3, "epoch": 0}}
    assert _equal(target, params) and _equal(target_opt, opt)
    assert target["embed"] is live  # loaded into the given tensors


def test_torn_and_corrupt_steps_walk_back(tmp_path):
    ck = _ckptr(tmp_path)
    for step in (1, 2, 3):
        ck.save(step, *_state(step))
    # step 3 torn: its save marker is still there (killed between tensors and manifest)
    open(tmp_path / "step_3" / SAVING_MARKER, "w").close()
    # step 2 corrupt: a byte of the optimizer file flipped after the manifest committed
    shard = next(p for p in (tmp_path / "step_2" / "optim").iterdir() if p.suffix == ".distcp")
    raw = bytearray(shard.read_bytes())
    raw[-1] ^= 0xFF
    shard.write_bytes(bytes(raw))
    assert ck.verify_step(3) and ck.verify_step(2) and ck.verify_step(1) == []
    assert ck.latest_step() == 2  # latest -> step_3 is incomplete: the scan decides
    target, target_opt = _state(9)
    _, step = ck.load_latest_verified(target, target_opt)
    assert step == 1 and _equal(target, _state(1)[0]) and _equal(target_opt, _state(1)[1])
    with pytest.raises(ValueError, match="integrity"):
        ck.load(target, target_opt, step=2)  # refused before any tensor is touched
    assert _equal(target, _state(1)[0]) and _equal(target_opt, _state(1)[1])
    assert _ckptr(tmp_path / "empty").load_latest_verified(*_state(0)) is None


def test_keep_last_k_spares_best_and_ignores_odd_dirs(tmp_path):
    (tmp_path / "step_final").mkdir(parents=True)
    (tmp_path / "step_3.bak").mkdir()
    ck = _ckptr(tmp_path, keep_last_k=2)
    ck.save(1, *_state(1))
    assert ck.mark_best(1, 0.5) and not ck.is_best(0.7) and ck.is_best(0.4)
    assert not ck.mark_best(1, 0.9)
    for step in (2, 3, 4):
        ck.save(step, *_state(step))
    steps = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert steps == ["step_1", "step_3", "step_3.bak", "step_4", "step_final"]
    assert ck.best_step() == 1 and os.readlink(tmp_path / "best") == "step_1"
    assert ck.latest_step() == 4
    (tmp_path / "best.json").write_text("{trunc")
    assert ck.best_step() is None and ck.is_best(10.0)


def test_changed_model_mesh_and_async_save_raise(tmp_path):
    ck = _ckptr(tmp_path)
    ck.topology = build_topology({"dp_shard": 1, "cp": 1})
    ck.save(1, *_state(1))
    params, opt = _state(1)
    params["embed"] = torch.nn.Parameter(torch.zeros(9, 4))
    with pytest.raises(ModelSignatureMismatch, match="embed"):
        ck.load_latest_verified(params, opt)
    ck.topology = build_topology({"dp_shard": 1, "cp": 2})
    assert mesh_delta(read_topology(ck.step_dir(1)), ck.topology) == {"cp": (1, 2),
                                                                     "world_size": (1, 2)}
    with pytest.raises(NotImplementedError, match="elastic"):
        ck.load(*_state(1))
    with pytest.raises(NotImplementedError, match="async_save"):
        _ckptr(tmp_path, async_save=True)
    assert _ckptr(tmp_path, enabled=False).save(2, *_state(2)) == ""


YAML = """
seed: 3
device: cpu
model:
  config:
    architectures: [LlamaForCausalLM]
    vocab_size: 96
    hidden_size: 32
    intermediate_size: 64
    num_hidden_layers: 2
    num_attention_heads: 4
    num_key_value_heads: 2
backend:
  dtype: float32
  attention: flash
dataset:
  _target_: automodel_tpu.data.llm.mock.MockSFTDataset
  vocab_size: 96
  seq_len: 16
  num_samples: 48
  seed: 0
micro_batch_size: 2
seq_len: 16
step_scheduler:
  grad_acc_steps: 2
  max_steps: 6
  ckpt_every_steps: 2
optimizer:
  lr: 1.0e-2
  weight_decay: 0.01
lr_scheduler:
  lr_warmup_steps: 2
checkpoint:
  enabled: true
  save_consolidated: true
"""


def _run(cfg_path, tmp_path, out, prefetch):
    cfg = parse_args_and_load_config([
        "-c", cfg_path, "--checkpoint.checkpoint_dir", str(tmp_path / "ck"),
        "--output_dir", str(tmp_path / out), "--dataloader.prefetch.enabled", str(prefetch)])
    recipe = train_ft.TrainFinetuneRecipeForNextTokenPrediction(cfg)
    recipe.setup()
    first, losses, step_fn = recipe.step_scheduler.step + 1, [], recipe._train_step

    def recorded(opt_state, stack):
        opt_state, m = step_fn(opt_state, stack)
        losses.append(float(m["loss"]))
        return opt_state, m

    recipe._train_step = recorded
    recipe.run_train_validation_loop()
    return recipe, {first + i: x for i, x in enumerate(losses)}


@pytest.mark.parametrize("prefetch", ["false", "true"], ids=["sync", "prefetch"])
def test_resumed_train_ft_continues_bitwise(tmp_path, prefetch):
    cfg_path = tmp_path / "tiny.yaml"
    cfg_path.write_text(textwrap.dedent(YAML))
    full, want = _run(str(cfg_path), tmp_path, "a", prefetch)
    assert sorted(want) == [1, 2, 3, 4, 5, 6]
    assert sorted(os.listdir(tmp_path / "ck" / "step_6" / "hf")) == ["config.json",
                                                                   "model.safetensors"]
    with open(tmp_path / "ck" / "step_2" / "client.json") as f:
        assert json.load(f)["step_scheduler"] == {"step": 2, "epoch": 0}
    for step in (4, 6):  # the walk-back must find step 2
        shutil.rmtree(tmp_path / "ck" / f"step_{step}")
    resumed, got = _run(str(cfg_path), tmp_path, "b", prefetch)
    assert sorted(got) == [3, 4, 5, 6]
    assert all(got[s] == want[s] for s in got), (got, want)
    for k, v in full.params.items():
        assert torch.equal(v, resumed.params[k]), k
    with open(tmp_path / "b" / "training.jsonl") as f:
        events = [r for r in map(json.loads, f) if "event" in r]
    assert [(r["event"], r["step"]) for r in events] == [
        ("checkpoint_restore", 2), ("checkpoint_save", 4), ("checkpoint_save", 6)]
    assert all(r["bytes"] > 0 for r in events[1:])
    np.testing.assert_array_equal(
        [resumed.step_scheduler.step, resumed.dataloader.state_dict()["cursor"]],
        [full.step_scheduler.step, full.dataloader.state_dict()["cursor"]])
