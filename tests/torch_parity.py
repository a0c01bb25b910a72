"""Helpers that the port's family tests share to hold a model against the JAX package's:
weights and batches from numpy seeds, named by the port's flat parameter names, which
JAX's trees flatten to; the logits, stats and gradients of both; a short train-step
trajectory of both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from automodel_tpu.ops.losses import masked_cross_entropy as jax_ce
from automodel_tpu.optim.builder import build_optimizer as jax_build_optimizer
from automodel_tpu.training.train_step import make_train_step as jax_make_train_step
from automodel_tpu_torch.models.llama.convert import flatten, params_from_jax
from automodel_tpu_torch.ops.losses import masked_cross_entropy
from automodel_tpu_torch.optim.builder import build_optimizer
from automodel_tpu_torch.training.train_step import make_train_step

OPT = dict(lr=1e-2, weight_decay=0.1, max_grad_norm=1.0)


def unflatten(flat: dict) -> dict:
    tree: dict = {}
    for name, value in flat.items():
        node = tree
        *path, leaf = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = value
    return tree


def jax_tree(shapes: dict, seed: int = 0, centred_norms: bool = False) -> dict:
    """A JAX parameter tree of ``shapes`` (the port's flat names) from a numpy seed:
    normal(0, 0.02) weights; norms at 1 + 0.1 normal, or 0.1 normal for the (1 + w)
    ones (``centred_norms``; a gated DeltaNet's ``norm`` stays a plain scale);
    correction and router biases 0.05 normal, so that they take part in the routing;
    ``dt_bias`` 1 + 0.1 normal and ``a_log`` log U(0.5, 2) in f32, Qwen3-Next's scales."""
    rng = np.random.RandomState(seed)
    flat = {}
    for name, shape in shapes.items():
        leaf = name.rsplit(".", 1)[-1]
        x = rng.randn(*shape)
        if leaf == "a_log":
            x = np.log(rng.uniform(0.5, 2.0, shape))
        elif leaf == "dt_bias":
            x = 1.0 + 0.1 * x
        elif leaf.endswith("norm"):
            x = 0.1 * x if centred_norms and leaf != "norm" else 1.0 + 0.1 * x
        elif leaf in ("score_correction_bias", "bias") or leaf.startswith("b"):
            x = 0.05 * x
        else:
            x = 0.02 * x
        flat[name] = x.astype(np.float32)
    return unflatten(flat)


def batch(seed: int = 0, b: int = 2, s: int = 24, vocab: int = 128):
    """ids, positions and segment ids: row 0 packs two documents, row 1 ends in 4 pads."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (b, s)).astype(np.int32)
    seg = np.ones((b, s), np.int32)
    seg[0, s // 2:] = 2
    seg[1, s - 4:] = 0
    pos = np.tile(np.arange(s), (b, 1))
    pos[0, s // 2:] = np.arange(s - s // 2)
    return ids, pos.astype(np.int32), seg


def port_model(cls, hf, params, **backend):
    """The port's model of ``hf`` (an HF config dict) on the CPU in f32 under the full
    remat policy, with the JAX tree's ``params``."""
    from automodel_tpu_torch.models.common.backend import BackendConfig

    model = cls.from_config(hf, BackendConfig(dtype="float32", remat_policy="full", **backend),
                            device="cpu")
    model.load_params(params_from_jax(params, model.config))
    return model


def forward_and_grads(jm, model, params, ids, pos, seg, vocab):
    """Both models' logits, stats and gradients of sum(logits * ct) + aux on one batch
    (the token mask: segment id != 0). Returns (jax (logits, stats, flat grads), port
    (logits, stats, {name: grad}))."""
    mask = seg != 0
    ct = np.random.RandomState(1).randn(*ids.shape, vocab).astype(np.float32) / ids.size

    def jax_loss(p):
        logits, stats = jm(p, jnp.asarray(ids), positions=jnp.asarray(pos),
                           segment_ids=jnp.asarray(seg), token_mask=jnp.asarray(mask))
        aux = stats["aux_loss"] if stats["aux_loss"] is not None else 0.0
        return jnp.sum(logits * ct) + aux, (logits, stats)

    (_, (jlogits, jstats)), jgrads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(params)
    names, leaves = zip(*model.param_dict().items())
    logits, stats = model(torch.tensor(ids), positions=torch.tensor(pos),
                          segment_ids=torch.tensor(seg), token_mask=torch.tensor(mask))
    loss = (logits * torch.tensor(ct)).sum()
    if stats["aux_loss"] is not None:
        loss = loss + stats["aux_loss"]
    grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    return ((np.asarray(jlogits), jax.device_get(jstats), flatten(jax.device_get(jgrads))),
            (logits.detach(), stats, dict(zip(names, grads))))


def assert_forward_and_grads_match(jm, model, params, ids, pos, seg, vocab, atol=1e-4):
    (jlogits, jstats, jgrads), (logits, stats, grads) = forward_and_grads(
        jm, model, params, ids, pos, seg, vocab)
    np.testing.assert_allclose(logits.numpy(), jlogits, atol=atol, rtol=0)
    np.testing.assert_array_equal(stats["expert_load"].numpy(),
                                  np.asarray(jstats["expert_load"]))
    if jstats["aux_loss"] is not None:
        np.testing.assert_allclose(stats["aux_loss"].item(), float(jstats["aux_loss"]),
                                   atol=1e-6, rtol=1e-5)
    else:
        assert stats["aux_loss"] is None
    assert set(grads) == set(jgrads)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), jgrads[name], atol=atol, rtol=0, err_msg=name)
    return stats


def trajectories(jm, model, params, vocab, steps=3, jax_post=None, port_post=None,
                 watch=None, aux_coeff=0.0):
    """``steps`` train steps of 2 microbatches (adamw with weight decay and clipping) in
    both packages from the same weights and batches: the losses of each, and, for the
    parameter ``watch``, its value after each step in each."""
    stacks = []
    for step in range(steps):
        micro = [batch(seed=10 * step + i, vocab=vocab) for i in range(2)]
        labels = np.stack([np.roll(ids, -1, axis=1) for ids, _, _ in micro])
        labels[:, :, -1] = -100
        labels[np.stack([seg for _, _, seg in micro]) == 0] = -100
        stacks.append({"input_ids": np.stack([m[0] for m in micro]),
                       "positions": np.stack([m[1] for m in micro]),
                       "segment_ids": np.stack([m[2] for m in micro]), "labels": labels})

    def jax_forward_loss(p, b, n):
        logits, stats = jm(p, b["input_ids"], positions=b["positions"],
                           segment_ids=b["segment_ids"], token_mask=b["segment_ids"] != 0)
        loss = jax_ce(logits, b["labels"], n)
        if stats["aux_loss"] is not None:
            loss = loss + aux_coeff * stats["aux_loss"]
        return loss, {"expert_load": stats["expert_load"]}

    jopt = jax_build_optimizer(**OPT)
    jstep = jax.jit(jax_make_train_step(jax_forward_loss, jopt, post_update=jax_post))
    jp, jstate = params, jopt.init(params)
    want, want_watch = [], []
    for stack in stacks:
        jp, jstate, m = jstep(jp, jstate, jax.tree.map(jnp.asarray, stack))
        want.append(float(m["loss"]))
        if watch:
            want_watch.append(np.asarray(flatten(jax.device_get(jp))[watch]))

    tparams = model.param_dict()

    def forward_loss(b, n):
        logits, stats = model(b["input_ids"], positions=b["positions"],
                              segment_ids=b["segment_ids"], token_mask=b["segment_ids"] != 0)
        loss = masked_cross_entropy(logits, b["labels"], n)
        if stats["aux_loss"] is not None:
            loss = loss + aux_coeff * stats["aux_loss"]
        return loss, {"expert_load": stats["expert_load"]}

    topt = build_optimizer(**OPT)
    step_fn = make_train_step(forward_loss, tparams, topt, post_update=port_post)
    state = topt.init(tparams)
    got, got_watch = [], []
    for stack in stacks:
        state, m = step_fn(state, {k: torch.tensor(v) for k, v in stack.items()})
        got.append(float(m["loss"]))
        if watch:
            got_watch.append(tparams[watch].detach().numpy().copy())
    return (want, want_watch), (got, got_watch)
