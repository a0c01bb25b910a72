"""Optimizer construction (counterpart of ``automodel_tpu/optim/builder.py``).

A functional optimizer in optax's shape: ``init(params) -> state`` and
``update(grads, state, params) -> (updates, state)`` over dicts of tensors named as
the JAX tree flattens them (``layers.wq``), then ``apply_updates``. The arithmetic is
optax's, transform by transform, so a step matches the JAX package's on the same
gradients:

- ``adamw``: ``optax.adamw`` (scale_by_adam, masked add_decayed_weights, -lr);
- ``adafactor_nomom``: ``optax.scale_by_factored_rms(decay_rate=betas[1])``, then the
  masked decay and -lr;
- ``adamw_lowmem``: the JAX package's ``low_mem_scale_by_adam`` (both moments stored in
  bf16, the math in f32), then the masked decay and -lr. Large leaves are updated in
  slices of at most ``_SLICE_ELEMS`` elements (rows of the leaf seen as a matrix, i.e.
  slices along its stacked leading dims), so the f32 temporaries stay a few hundred MB
  whatever the leaf; the arithmetic is elementwise, so the slices change no value;
- both behind ``optax.clip_by_global_norm`` when ``max_grad_norm`` is set.

Other optimizer names raise NotImplementedError until a slice ports them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

__all__ = ["Optimizer", "apply_updates", "build_optimizer", "global_norm", "no_decay_mask"]

Tree = dict[str, torch.Tensor]


def no_decay_mask(params: Tree) -> dict[str, bool]:
    """True where weight decay applies: per-layer rank >= 2 (stacked leaves under
    ``layers.`` carry one extra leading dim), as the JAX mask decides. JAX treats only
    the key ``layers`` as stacked, so ``moe_layers.`` / ``dense_layers.`` norms (rank 2
    with their stack dim) decay there, and here alike."""
    return {k: v.ndim - (1 if k.startswith("layers.") else 0) >= 2 for k, v in params.items()}


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32."""
    return torch.sqrt(sum(torch.sum(t.float() ** 2) for t in tree.values()))


def apply_updates(params: Tree, updates: Tree) -> None:
    """params += updates in place, in each parameter's dtype (optax.apply_updates)."""
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(p + updates[k])


def _clip(max_norm):
    def update(grads, state, params):
        g_norm = global_norm(grads)
        keep = g_norm < max_norm
        return {k: torch.where(keep, g, (g / g_norm.to(g.dtype)) * max_norm)
                for k, g in grads.items()}, state
    return (lambda params: {}), update


def _scale_by_adam(b1, b2, eps):
    def init(params):
        return {"count": torch.zeros((), dtype=torch.int32),
                "mu": {k: torch.zeros_like(p) for k, p in params.items()},
                "nu": {k: torch.zeros_like(p) for k, p in params.items()}}

    def update(grads, state, params):
        count = state["count"] + 1
        mu = {k: b1 * state["mu"][k] + (1 - b1) * g for k, g in grads.items()}
        nu = {k: b2 * state["nu"][k] + (1 - b2) * g * g for k, g in grads.items()}
        bc1 = 1 - b1 ** count.item()
        bc2 = 1 - b2 ** count.item()
        upd = {k: (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + eps) for k in grads}
        return upd, {"count": count, "mu": mu, "nu": nu}
    return init, update


_SLICE_ELEMS = 1 << 26  # elements per slice of the adamw_lowmem update (256 MB in f32)


def _row_slices(t: torch.Tensor, max_elems: int):
    """Views of contiguous ``t`` (as rows of its last dim) of at most ``max_elems``
    elements each, or of one row when a row is larger."""
    rows = t.reshape(-1, t.shape[-1]) if t.ndim else t.reshape(1, 1)
    step = max(max_elems // rows.shape[1], 1)
    return [rows[i:i + step] for i in range(0, rows.shape[0], step)]


def _scale_by_adam_lowmem(b1, b2, eps, slice_elems=_SLICE_ELEMS):
    """low_mem_scale_by_adam: bf16 mu and nu, f32 math, updates in the gradient's dtype."""
    def zeros(p):  # contiguous, so that the row slices below are views
        return torch.zeros(p.shape, dtype=torch.bfloat16, device=p.device)

    def init(params):
        return {"count": torch.zeros((), dtype=torch.int32),
                "mu": {k: zeros(p) for k, p in params.items()},
                "nu": {k: zeros(p) for k, p in params.items()}}

    def update(grads, state, params):
        count = state["count"] + 1
        # bias corrections in f32, as JAX computes them from the f32 count
        bc1 = (1 - torch.tensor(b1, dtype=torch.float32) ** count.float()).item()
        bc2 = (1 - torch.tensor(b2, dtype=torch.float32) ** count.float()).item()
        upd, mu, nu = {}, {}, {}
        for k, g in grads.items():
            g = g.contiguous()
            upd[k] = torch.empty(g.shape, dtype=g.dtype, device=g.device)
            mu[k], nu[k] = (torch.empty(g.shape, dtype=torch.bfloat16, device=g.device)
                            for _ in range(2))
            for gs, ms, ns, us, mo, no in zip(*(_row_slices(t, slice_elems) for t in (
                    g, state["mu"][k].contiguous(), state["nu"][k].contiguous(), upd[k],
                    mu[k], nu[k]))):
                g32 = gs.float()
                mu32 = b1 * ms.float() + (1 - b1) * g32
                nu32 = b2 * ns.float() + (1 - b2) * g32 * g32
                us.copy_((mu32 / bc1) / (torch.sqrt(nu32 / bc2) + eps))
                mo.copy_(mu32)
                no.copy_(nu32)
        return upd, {"count": count, "mu": mu, "nu": nu}
    return init, update


def _factored_dims(shape, min_dim_size_to_factor=128):
    """optax._factored_dims: the two largest axes (stable order), or None."""
    if len(shape) < 2:
        return None
    order = sorted(range(len(shape)), key=lambda i: shape[i])
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return order[-2], order[-1]


def _scale_by_factored_rms(decay_rate, epsilon=1e-30):
    """optax.scale_by_factored_rms with its defaults (factored, min dim 128, step
    offset 0, decay_rate_fn = 1 - (step + 1) ** -decay_rate)."""
    def init(params):
        v_row, v_col, v = {}, {}, {}
        for k, p in params.items():
            dims = _factored_dims(p.shape)
            z1 = torch.zeros((1,), dtype=p.dtype, device=p.device)
            if dims is None:
                v_row[k], v_col[k], v[k] = z1, z1, torch.zeros_like(p)
            else:
                d1, d0 = dims
                shape = list(p.shape)
                v_row[k] = torch.zeros(shape[:d0] + shape[d0 + 1:], dtype=p.dtype, device=p.device)
                v_col[k] = torch.zeros(shape[:d1] + shape[d1 + 1:], dtype=p.dtype, device=p.device)
                v[k] = z1
        return {"count": torch.zeros((), dtype=torch.int32), "v_row": v_row, "v_col": v_col,
                "v": v}

    def update(grads, state, params):
        step = state["count"].item()
        decay = 1.0 - (step + 1.0) ** (-decay_rate)
        updates, v_row, v_col, v = {}, {}, {}, {}
        for k, g in grads.items():
            dtype = params[k].dtype
            dims = _factored_dims(params[k].shape)
            grad_sqr = g * g + epsilon
            if dims is not None:
                d1, d0 = dims
                new_row = (decay * state["v_row"][k] + (1 - decay) * grad_sqr.mean(d0)).to(dtype)
                new_col = (decay * state["v_col"][k] + (1 - decay) * grad_sqr.mean(d1)).to(dtype)
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row_col_mean = new_row.mean(reduced_d1, keepdim=True)
                row_factor = (new_row / row_col_mean) ** -0.5
                col_factor = new_col ** -0.5
                updates[k] = g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
                v_row[k], v_col[k], v[k] = new_row, new_col, state["v"][k]
            else:
                new_v = (decay * state["v"][k] + (1 - decay) * grad_sqr).to(dtype)
                updates[k] = g * new_v ** -0.5
                v_row[k], v_col[k], v[k] = state["v_row"][k], state["v_col"][k], new_v
        return updates, {"count": state["count"] + 1, "v_row": v_row, "v_col": v_col, "v": v}
    return init, update


def _add_decayed_weights(weight_decay, mask_fn):
    def update(grads, state, params):
        mask = mask_fn(params)
        return {k: g + weight_decay * params[k] if mask[k] else g
                for k, g in grads.items()}, state
    return (lambda params: {}), update


def _scale_by_learning_rate(lr):
    """optax.scale_by_learning_rate: multiply by -lr(count), count before increment."""
    def init(params):
        return {"count": torch.zeros((), dtype=torch.int32)}

    def update(grads, state, params):
        step = state["count"].item()
        rate = float(lr(step)) if callable(lr) else float(lr)
        return {k: -rate * g for k, g in grads.items()}, {"count": state["count"] + 1}
    return init, update


@dataclasses.dataclass
class Optimizer:
    """optax.chain of (init, update) pairs."""

    transforms: list

    def init(self, params: Tree) -> list:
        return [init(params) for init, _ in self.transforms]

    def update(self, grads: Tree, state: list, params: Tree) -> tuple[Tree, list]:
        new_state = []
        for (_, update), s in zip(self.transforms, state):
            grads, s = update(grads, s, params)
            new_state.append(s)
        return grads, new_state


def build_optimizer(
    lr: float | Callable[[int], float],
    weight_decay: float = 0.0,
    betas: tuple[float, float] = (0.9, 0.95),
    eps: float = 1e-8,
    max_grad_norm: float | None = None,
    optimizer: str = "adamw",
    **optimizer_kwargs,
) -> Optimizer:
    """AdamW or momentum-free Adafactor, with decay masking and global-norm clipping."""
    if optimizer_kwargs:
        raise ValueError(f"unknown optimizer kwargs for {optimizer!r}: {sorted(optimizer_kwargs)}")
    chain = []
    if max_grad_norm is not None and max_grad_norm > 0:
        chain.append(_clip(max_grad_norm))
    if optimizer == "adamw":
        chain.append(_scale_by_adam(betas[0], betas[1], eps))
    elif optimizer == "adamw_lowmem":
        chain.append(_scale_by_adam_lowmem(betas[0], betas[1], eps))
    elif optimizer == "adafactor_nomom":
        chain.append(_scale_by_factored_rms(decay_rate=betas[1]))
    else:
        raise NotImplementedError(
            f"optimizer {optimizer!r} is not ported to the PyTorch package yet "
            "(adamw | adamw_lowmem | adafactor_nomom)")
    if weight_decay:
        chain.append(_add_decayed_weights(weight_decay, no_decay_mask))
    chain.append(_scale_by_learning_rate(lr))
    return Optimizer(chain)
