"""The port's train step and optimizers against the JAX package's make_train_step +
build_optimizer: 3 steps, 2 accumulated microbatches, global-norm clipping on, for
adamw (with warmup and weight decay) and adafactor_nomom. The model (vocab 256,
hidden 128, intermediate 256) makes optax factor the embedding and MLP moments.
Losses agree to 1e-4 absolute; parameters to 1e-4 relative (max |diff| over max |ref|
per tensor).

adamw runs with eps 1e-5: with the default 1e-8 its first update is g / (|g| + eps),
close to sign(g), and a gradient element that cancels to ~1e-8 (one of the embedding's
here) carries a different f32 rounding in each package, which that ratio amplifies
past any tolerance on the parameters. The losses match either way."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automodel_tpu.models.common.backend import BackendConfig as JaxBackend
from automodel_tpu.models.llama.model import LlamaForCausalLM as JaxLlama
from automodel_tpu.ops.losses import masked_cross_entropy as jax_ce
from automodel_tpu.optim.builder import build_optimizer as jax_build_optimizer
from automodel_tpu.optim.scheduler import build_lr_schedule as jax_schedule
from automodel_tpu.training.train_step import make_train_step as jax_make_train_step
from automodel_tpu_torch.data.collate import sft_collate, stack_batches
from automodel_tpu_torch.data.llm.mock import MockSFTDataset
from automodel_tpu_torch.models.common.backend import BackendConfig
from automodel_tpu_torch.models.llama.convert import params_from_jax
from automodel_tpu_torch.models.llama.model import LlamaForCausalLM
from automodel_tpu_torch.ops.losses import masked_cross_entropy
from automodel_tpu_torch.optim.builder import build_optimizer, global_norm
from automodel_tpu_torch.optim.scheduler import build_lr_schedule
from automodel_tpu_torch.training.train_step import make_train_step

HF = dict(architectures=["LlamaForCausalLM"], vocab_size=256, hidden_size=128,
          intermediate_size=256, num_hidden_layers=2, num_attention_heads=4,
          num_key_value_heads=2, tie_word_embeddings=False)
SCHED = dict(max_lr=3e-3, min_lr=3e-4, lr_warmup_steps=2, lr_decay_steps=3)
OPTIMIZERS = {
    "adamw": dict(optimizer="adamw", weight_decay=0.1, max_grad_norm=0.5, eps=1e-5),
    "adafactor_nomom": dict(optimizer="adafactor_nomom", max_grad_norm=0.5),
}


def _batches(n_steps=3, grad_acc=2, b=2, s=32):
    ds = MockSFTDataset(256, s, num_samples=64, seed=3)
    out = []
    for step in range(n_steps):
        micro = [sft_collate([ds[(step * grad_acc + m) * b + r] for r in range(b)], s)
                 for m in range(grad_acc)]
        out.append(stack_batches(micro))
    return out


def _jax_run(params, opt_kw, batches):
    model = JaxLlama.from_config(HF, JaxBackend(dtype="float32", remat_policy="full"))

    def forward_loss(p, batch, n):
        logits = model(p, batch["input_ids"], positions=batch["positions"],
                       segment_ids=batch["segment_ids"])
        return jax_ce(logits, batch["labels"], n)

    opt = jax_build_optimizer(lr=jax_schedule(**SCHED), betas=(0.9, 0.95), **opt_kw)
    step = jax.jit(make := jax_make_train_step(forward_loss, opt))
    del make
    state = opt.init(params)
    metrics = []
    for batch in batches:
        params, state, m = step(params, state, {k: jnp.asarray(v) for k, v in batch.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return jax.device_get(params), metrics


def _torch_run(jax_params, opt_kw, batches):
    model = LlamaForCausalLM.from_config(HF, BackendConfig(dtype="float32", remat_policy="full"),
                                         device="cpu")
    model.load_params(params_from_jax(jax_params, model.config))
    params = model.param_dict()

    def forward_loss(batch, n):
        logits = model(batch["input_ids"], positions=batch["positions"],
                       segment_ids=batch["segment_ids"])
        return masked_cross_entropy(logits, batch["labels"], n)

    opt = build_optimizer(lr=build_lr_schedule(**SCHED), betas=(0.9, 0.95), **opt_kw)
    step = make_train_step(forward_loss, params, opt)
    state = opt.init(params)
    metrics = []
    for batch in batches:
        state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return {k: v.detach() for k, v in params.items()}, metrics


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_three_steps_match_jax(name):
    init = jax.device_get(JaxLlama.from_config(HF, JaxBackend(dtype="float32")).init(
        jax.random.key(1)))
    batches = _batches()
    jax_params, jax_metrics = _jax_run(init, OPTIMIZERS[name], batches)
    torch_params, torch_metrics = _torch_run(init, OPTIMIZERS[name], batches)
    for jm, tm in zip(jax_metrics, torch_metrics):
        assert tm["loss"] == pytest.approx(jm["loss"], abs=1e-4)
        assert tm["grad_norm"] == pytest.approx(jm["grad_norm"], rel=1e-4)
        assert tm["num_label_tokens"] == jm["num_label_tokens"]
    assert jax_metrics[0]["grad_norm"] > OPTIMIZERS[name]["max_grad_norm"]  # clipping ran
    want = params_from_jax(jax_params, LlamaForCausalLM.from_config(
        HF, device="cpu").config)
    for key, ref in want.items():
        err = (torch_params[key] - ref).abs().max() / ref.abs().max()
        assert err <= 1e-4, f"{key}: relative error {err:.2e}"


def test_nonfinite_step_keeps_params_and_state():
    """guard_nonfinite: a NaN loss zeroes the update and keeps the optimizer state."""
    w = torch.nn.Parameter(torch.ones(4, 3))
    opt = build_optimizer(lr=0.1, optimizer="adamw")
    state = opt.init({"w": w})

    def forward_loss(batch, n):
        return (w * batch["x"]).sum() * torch.tensor(float("nan"))

    step = make_train_step(forward_loss, {"w": w}, opt, guard_nonfinite=True)
    batch = {"x": torch.ones(1, 4, 3), "labels": torch.ones(1, 4, dtype=torch.long)}
    new_state, m = step(state, batch)
    assert bool(m["nonfinite"])
    torch.testing.assert_close(w.detach(), torch.ones(4, 3))
    torch.testing.assert_close(new_state[0]["mu"]["w"], state[0]["mu"]["w"])


def test_unported_optimizer_raises():
    with pytest.raises(NotImplementedError):
        build_optimizer(lr=1e-3, optimizer="adafactor_momentum")


def test_global_norm():
    tree = {"a": torch.ones(3), "b": torch.full((2, 2), 2.0)}
    assert float(global_norm(tree)) == pytest.approx(np.sqrt(3 + 16))
