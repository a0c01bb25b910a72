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
from tests.torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

HF = dict(architectures=["LlamaForCausalLM"], vocab_size=256, hidden_size=128,
          intermediate_size=256, num_hidden_layers=2, num_attention_heads=4,
          num_key_value_heads=2, tie_word_embeddings=False)
SCHED = dict(max_lr=3e-3, min_lr=3e-4, lr_warmup_steps=2, lr_decay_steps=3)
OPTIMIZERS = {
    "adamw": dict(optimizer="adamw", weight_decay=0.1, max_grad_norm=0.5, eps=1e-5),
    "adafactor_nomom": dict(optimizer="adafactor_nomom", max_grad_norm=0.5),
    "adamw_lowmem": dict(optimizer="adamw_lowmem", weight_decay=0.1, max_grad_norm=0.5,
                         eps=1e-5),
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
        diff = (torch_params[key] - ref).abs()
        err = diff.max() / ref.abs().max()
        if name == "adamw_lowmem":
            # bf16 moments: an f32 moment a last bit apart in the two packages can round
            # to neighbouring bf16 values (2^-8 apart), which moves that element's update
            # by up to ~0.8% of lr (3e-3), i.e. ~2.3e-5; such flips stay rare
            assert err <= 1e-3, f"{key}: relative error {err:.2e}"
            assert (diff > 1e-6).float().mean() <= 0.01, f"{key}: flips not rare"
        else:
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
    before = [{k: (v.clone() if torch.is_tensor(v) else {n: t.clone() for n, t in v.items()})
               for k, v in s.items()} for s in state]  # the step overwrites the state
    new_state, m = step(state, batch)
    assert bool(m["nonfinite"])
    torch.testing.assert_close(w.detach(), torch.ones(4, 3))
    torch.testing.assert_close(new_state[0]["mu"]["w"], before[0]["mu"]["w"])
    torch.testing.assert_close(new_state[0]["nu"]["w"], before[0]["nu"]["w"])
    assert int(new_state[0]["count"]) == int(new_state[-1]["count"]) == 0


def test_unported_optimizer_raises():
    with pytest.raises(NotImplementedError):
        build_optimizer(lr=1e-3, optimizer="adafactor_momentum")


def test_global_norm():
    tree = {"a": torch.ones(3), "b": torch.full((2, 2), 2.0)}
    assert float(global_norm(tree)) == pytest.approx(np.sqrt(3 + 16))


def test_adamw_lowmem_slices_change_no_value():
    """The sliced update (slices of 7 elements, so rows split and leaves of every rank
    take several slices) equals the whole-leaf update bit for bit, state included."""
    from automodel_tpu_torch.optim import builder

    gen = torch.Generator().manual_seed(0)
    params = {"a": torch.randn(3, 5, 4, generator=gen), "b": torch.randn(6, generator=gen),
              "c": torch.randn(2, 40, generator=gen).to(torch.bfloat16)}
    out = {}
    for budget in (7, 1 << 26):
        init, begin = builder._scale_by_adam_lowmem(0.9, 0.95, 1e-8, slice_elems=budget)
        state = init(params)
        for step in range(3):
            grads = {k: torch.randn(p.shape, generator=torch.Generator().manual_seed(step))
                     .to(p.dtype) for k, p in params.items()}
            leaf, finish = begin(grads, state, params, None)
            upd = {k: leaf(k, g) for k, g in grads.items()}
            state = finish()
        out[budget] = (upd, state)
    (u1, s1), (u2, s2) = out.values()
    for k in params:
        assert u1[k].dtype == params[k].dtype
        assert torch.equal(u1[k], u2[k])
        assert torch.equal(s1["mu"][k], s2["mu"][k]) and s1["mu"][k].dtype == torch.bfloat16
        assert torch.equal(s1["nu"][k], s2["nu"][k]) and s1["nu"][k].dtype == torch.bfloat16
    assert int(s1["count"]) == 3


def test_aux_sums_over_microbatches_as_jax():
    """forward_loss may return (loss, aux): aux tensors sum over the microbatches into
    the metrics, as the JAX step's scan carry sums them."""
    rng = np.random.RandomState(0)
    x = rng.randn(3, 4, 5).astype(np.float32)  # 3 microbatches
    labels = np.ones((3, 4), np.int32)
    w0 = rng.randn(5).astype(np.float32)

    def jax_fwd(p, batch, n):
        y = batch["x"] @ p["w"]
        return jnp.sum(y ** 2) / n, {"expert_load": jnp.abs(batch["x"]).sum(0),
                                     "moe_aux_loss": jnp.sum(y) / n}

    jstep = jax.jit(jax_make_train_step(jax_fwd, jax_build_optimizer(lr=0.1)))
    jparams, _, jm = jstep({"w": jnp.asarray(w0)}, jax_build_optimizer(lr=0.1).init(
        {"w": jnp.asarray(w0)}), {"x": jnp.asarray(x), "labels": jnp.asarray(labels)})

    w = torch.nn.Parameter(torch.tensor(w0))

    def fwd(batch, n):
        y = batch["x"] @ w
        return (y ** 2).sum() / n, {"expert_load": batch["x"].abs().sum(0),
                                    "moe_aux_loss": y.sum() / n}

    opt = build_optimizer(lr=0.1)
    _, m = make_train_step(fwd, {"w": w}, opt)(opt.init({"w": w}), {
        "x": torch.tensor(x), "labels": torch.tensor(labels)})
    for k in ("loss", "moe_aux_loss", "expert_load"):
        np.testing.assert_allclose(m[k].numpy(), np.asarray(jm[k]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(jparams["w"]), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("name", ["adamw", "adamw_lowmem", "adafactor_nomom"])
def test_guard_skips_a_nonfinite_step_slice_by_slice(name):
    """With clipping, weight decay and a schedule (adamw_lowmem in slices of 7 elements,
    so leaves of every rank take several; adafactor_nomom factored and not), a guarded
    run whose second of four steps is NaN ends with the parameters and optimizer state of
    an unguarded run of the three finite steps, bit for bit: the skipped step changes no
    slice and no count."""
    from automodel_tpu_torch.optim import builder

    gen = torch.Generator().manual_seed(1)
    init = {"layers.w": torch.randn(3, 5, 4, generator=gen), "b": torch.randn(6, generator=gen),
            "c": torch.randn(2, 40, generator=gen).to(torch.bfloat16),
            "big": torch.randn(130, 129, generator=gen)}  # factored by adafactor
    x = torch.randn(8, 4, generator=gen)
    results = []
    for scales in ([1.0, float("nan"), 2.0, 3.0], [1.0, 2.0, 3.0]):
        params = {k: v.clone().requires_grad_() for k, v in init.items()}
        opt = builder.build_optimizer(lambda step: 0.1 / (step + 1), weight_decay=0.1,
                                      max_grad_norm=0.5, optimizer=name)
        if name == "adamw_lowmem":
            opt.transforms[1] = builder._scale_by_adam_lowmem(0.9, 0.95, 1e-8, slice_elems=7)

        def loss_fn(batch, n):
            y = (batch["x"] @ params["layers.w"].sum(0).T).sum() + params["b"].sum() ** 2
            y = y + params["big"].sin().sum() + params["c"].float().pow(2).sum()
            return y * batch["s"][0] / n

        step = make_train_step(loss_fn, params, opt, guard_nonfinite=len(scales) == 4)
        state = opt.init(params)
        for s in scales:
            state, m = step(state, {"x": (x * s)[None], "s": torch.tensor([[s]]),
                                    "labels": torch.zeros(1, 4, dtype=torch.long)})
        results.append((params, state))
    (p1, s1), (p2, s2) = results
    for k in init:
        assert torch.equal(p1[k], p2[k]), k
        for slot in ("mu", "nu", "v_row", "v_col", "v"):
            if slot in s1[1]:  # the link after the clip
                assert torch.equal(s1[1][slot][k], s2[1][slot][k]), (slot, k)
    assert [int(s["count"]) for s in s1 if "count" in s] == [3, 3]
    assert [int(s["count"]) for s in s2 if "count" in s] == [3, 3]
    assert not torch.equal(p1["big"], init["big"])


def test_microbatch_sum_keeps_shared_gradients_apart():
    """Two parameters added directly get the same gradient tensor from autograd, and a
    summed one a stride-0 gradient; the in-place sum over microbatches still gives each
    its own sum (a + b's values)."""
    from automodel_tpu_torch.optim import builder

    a, b = torch.ones(3, requires_grad=True), torch.full((3,), 2.0, requires_grad=True)
    c = torch.zeros(2, 3, requires_grad=True)
    params = {"a": a, "b": b, "c": c}
    opt = build_optimizer(1.0)
    seen = {}

    def loss_fn(batch, n):
        return (((a + b) * batch["x"]).sum() + c.sum() * batch["x"][0]) / n

    def begin(grads, state, params, ok):
        seen.update({k: g.clone() for k, g in grads.items()})
        return (lambda name, g: g.zero_()), lambda: state

    opt.transforms[:] = [builder.Transform(lambda params: {}, begin)]
    step = make_train_step(loss_fn, params, opt)
    x = torch.tensor([[1.0, 2.0, 3.0], [10.0, 20.0, 30.0]])
    step(opt.init(params), {"x": x, "labels": torch.zeros(2, 1, dtype=torch.long)})
    assert torch.equal(seen["a"], seen["b"]) and torch.equal(seen["a"], x.sum(0) / 2)
    assert torch.equal(seen["c"], torch.full((2, 3), 11.0 / 2))
