"""Optimizer construction (counterpart of ``automodel_tpu/optim/builder.py``).

An optimizer in optax's shape, a chain of transforms over dicts of tensors named as the
JAX tree flattens them (``layers.wq``), applied in place: :meth:`Optimizer.step` takes
each gradient in turn through every link in its own buffer (clipped, scaled, decayed,
times -lr), adds it to its parameter, and frees it before the next leaf starts; the
moments are overwritten where they lie, a slice of at most ``_SLICE_ELEMS`` elements at a
time (rows of the leaf seen as a matrix, i.e. slices along its stacked leading dims), so
the step's peak holds no full-size copy of the gradients or moments and its f32
temporaries stay a few hundred MB whatever the leaf. The arithmetic is optax's, link by
link and elementwise, so a step matches the JAX package's on the same gradients:

- ``adamw``: ``optax.adamw`` (scale_by_adam, masked add_decayed_weights, -lr);
- ``adafactor_nomom``: ``optax.scale_by_factored_rms(decay_rate=betas[1])``, then the
  masked decay and -lr;
- ``adamw_lowmem``: the JAX package's ``low_mem_scale_by_adam`` (both moments stored in
  bf16, the math in f32), then the masked decay and -lr;
- each behind ``optax.clip_by_global_norm`` when ``max_grad_norm`` is set.

A step given an ``ok`` flag (a device bool, the train step's non-finite guard) writes
each slice of the parameters and the state as ``where(ok, new, old)``: a skipped step
keeps both, without a host sync.

Other optimizer names raise NotImplementedError until a slice ports them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

__all__ = ["Optimizer", "build_optimizer", "global_norm", "no_decay_mask"]

Tree = dict[str, torch.Tensor]


def no_decay_mask(params: Tree) -> dict[str, bool]:
    """True where weight decay applies: per-layer rank >= 2 (stacked leaves under
    ``layers.`` carry one extra leading dim), as the JAX mask decides. JAX treats only
    the key ``layers`` as stacked, so ``moe_layers.`` / ``dense_layers.`` norms (rank 2
    with their stack dim) decay there, and here alike."""
    return {k: v.ndim - (1 if k.startswith("layers.") else 0) >= 2 for k, v in params.items()}


_SLICE_ELEMS = 1 << 26  # elements per slice of an in-place or f32 pass (256 MB in f32)


def _row_slices(t: torch.Tensor, max_elems: int = _SLICE_ELEMS):
    """Views of contiguous ``t`` (as rows of its last dim) of at most ``max_elems``
    elements each, or of one row when a row is larger."""
    rows = t.reshape(-1, t.shape[-1]) if t.ndim else t.reshape(1, 1)
    step = max(max_elems // rows.shape[1], 1)
    return [rows[i:i + step] for i in range(0, rows.shape[0], step)]


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32, a slice at a time (no f32 copy of
    a whole leaf)."""
    return torch.sqrt(sum(torch.sum(s.float() ** 2) for t in tree.values()
                          for s in _row_slices(t.contiguous())))


def _keep(ok: torch.Tensor | None, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """``new``, or ``old`` where the step is skipped (``ok`` false)."""
    return new if ok is None else torch.where(ok.to(new.device), new, old)


def _apply_leaf(p: torch.Tensor, u: torch.Tensor, ok: torch.Tensor | None) -> None:
    """p += u in p's dtype (optax.apply_updates), a zero update on a skipped step."""
    pairs = (((p, u),) if not p.is_contiguous()
             else zip(_row_slices(p), _row_slices(u.contiguous())))
    for ps, us in pairs:
        ps.copy_(ps + (us if ok is None else torch.where(ok, us, 0.0)))


def _contiguous_moments(state: dict, name: str) -> tuple[torch.Tensor, torch.Tensor]:
    """The leaf's (mu, nu), made contiguous where they lie so that slices are views."""
    for moment in ("mu", "nu"):
        if not state[moment][name].is_contiguous():
            state[moment][name] = state[moment][name].contiguous()
    return state["mu"][name], state["nu"][name]


class Transform(NamedTuple):
    """One link of the chain: ``init(params) -> state``, and ``begin(grads, state,
    params, ok) -> (leaf, finish)``, called once a step with every gradient (for the
    link's global quantities: the clip's norm, the step count): ``leaf(name, g)``
    transforms one contiguous gradient in place, updates the link's state for that leaf,
    and returns it; ``finish()`` returns the link's new state."""

    init: Callable
    begin: Callable


def _no_state(params):
    return {}


def _clip(max_norm):
    def begin(grads, state, params, ok):
        g_norm = global_norm(grads)
        keep = g_norm < max_norm

        def leaf(name, g):
            for gs in _row_slices(g):
                gs.copy_(torch.where(keep, gs, (gs / g_norm.to(gs.dtype)) * max_norm))
            return g

        return leaf, lambda: state

    return Transform(_no_state, begin)


def _scale_by_adam(b1, b2, eps):
    def init(params):
        return {"count": torch.zeros((), dtype=torch.int32),
                "mu": {k: torch.zeros_like(p) for k, p in params.items()},
                "nu": {k: torch.zeros_like(p) for k, p in params.items()}}

    def begin(grads, state, params, ok):
        count = state["count"] + 1
        bc1 = 1 - b1 ** count.item()
        bc2 = 1 - b2 ** count.item()

        def leaf(name, g):
            for gs, ms, ns in zip(*map(_row_slices, (g, *_contiguous_moments(state, name)))):
                mu = b1 * ms + (1 - b1) * gs
                nu = b2 * ns + (1 - b2) * gs * gs
                gs.copy_((mu / bc1) / (torch.sqrt(nu / bc2) + eps))
                ms.copy_(_keep(ok, mu, ms))
                ns.copy_(_keep(ok, nu, ns))
            return g

        def finish():
            state["count"] = _keep(ok, count, state["count"])
            return state

        return leaf, finish

    return Transform(init, begin)


def _scale_by_adam_lowmem(b1, b2, eps, slice_elems=_SLICE_ELEMS):
    """low_mem_scale_by_adam: bf16 mu and nu, f32 math, updates in the gradient's dtype."""
    def zeros(p):  # contiguous, so that the row slices below are views
        return torch.zeros(p.shape, dtype=torch.bfloat16, device=p.device)

    def init(params):
        return {"count": torch.zeros((), dtype=torch.int32),
                "mu": {k: zeros(p) for k, p in params.items()},
                "nu": {k: zeros(p) for k, p in params.items()}}

    def begin(grads, state, params, ok):
        count = state["count"] + 1
        # bias corrections in f32, as JAX computes them from the f32 count
        bc1 = (1 - torch.tensor(b1, dtype=torch.float32) ** count.float()).item()
        bc2 = (1 - torch.tensor(b2, dtype=torch.float32) ** count.float()).item()

        def leaf(name, g):
            for gs, ms, ns in zip(*(_row_slices(t, slice_elems) for t in (
                    g, *_contiguous_moments(state, name)))):
                g32 = gs.float()
                mu32 = b1 * ms.float() + (1 - b1) * g32
                nu32 = b2 * ns.float() + (1 - b2) * g32 * g32
                gs.copy_((mu32 / bc1) / (torch.sqrt(nu32 / bc2) + eps))
                ms.copy_(_keep(ok, mu32, ms))
                ns.copy_(_keep(ok, nu32, ns))
            return g

        def finish():
            state["count"] = _keep(ok, count, state["count"])
            return state

        return leaf, finish

    return Transform(init, begin)


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

    def begin(grads, state, params, ok):
        step = state["count"].item()
        decay = 1.0 - (step + 1.0) ** (-decay_rate)
        new = {"count": _keep(ok, state["count"] + 1, state["count"]),
               "v_row": dict(state["v_row"]), "v_col": dict(state["v_col"]),
               "v": dict(state["v"])}

        def leaf(name, g):
            dtype = params[name].dtype
            dims = _factored_dims(params[name].shape)
            grad_sqr = g * g + epsilon
            if dims is None:
                new_v = (decay * state["v"][name] + (1 - decay) * grad_sqr).to(dtype)
                new["v"][name] = _keep(ok, new_v, state["v"][name])
                return g.mul_(new_v ** -0.5)
            d1, d0 = dims
            new_row = (decay * state["v_row"][name] + (1 - decay) * grad_sqr.mean(d0)).to(dtype)
            new_col = (decay * state["v_col"][name] + (1 - decay) * grad_sqr.mean(d1)).to(dtype)
            del grad_sqr
            row_col_mean = new_row.mean(d1 - 1 if d1 > d0 else d1, keepdim=True)
            new["v_row"][name] = _keep(ok, new_row, state["v_row"][name])
            new["v_col"][name] = _keep(ok, new_col, state["v_col"][name])
            return g.mul_(((new_row / row_col_mean) ** -0.5).unsqueeze(d0)).mul_(
                (new_col ** -0.5).unsqueeze(d1))

        return leaf, lambda: new

    return Transform(init, begin)


def _add_decayed_weights(weight_decay, mask_fn):
    def begin(grads, state, params, ok):
        mask = mask_fn(params)

        def leaf(name, g):
            if mask[name]:
                for gs, ps in zip(_row_slices(g), _row_slices(params[name].contiguous())):
                    gs.copy_(gs + weight_decay * ps)
            return g

        return leaf, lambda: state

    return Transform(_no_state, begin)


def _scale_by_learning_rate(lr):
    """optax.scale_by_learning_rate: multiply by -lr(count), count before increment."""
    def init(params):
        return {"count": torch.zeros((), dtype=torch.int32)}

    def begin(grads, state, params, ok):
        step = state["count"].item()
        rate = float(lr(step)) if callable(lr) else float(lr)
        return ((lambda name, g: g.mul_(-rate)),
                lambda: {"count": _keep(ok, state["count"] + 1, state["count"])})

    return Transform(init, begin)


@dataclasses.dataclass
class Optimizer:
    """optax.chain of :class:`Transform` links, applied in place."""

    transforms: list

    def init(self, params: Tree) -> list:
        return [t.init(params) for t in self.transforms]

    def step(self, grads: Tree, state: list, params: Tree,
             ok: torch.Tensor | None = None) -> list:
        """Apply the chain's update to ``params`` in place, leaf by leaf: each gradient
        (which the step consumes: ``grads`` is emptied) runs through every link in its own
        buffer and is added to its parameter before the next leaf starts; the state's
        leaves are overwritten in place. With ``ok`` (a bool tensor), a false flag keeps
        the parameters and the state as they were. Returns the new state."""
        links = [t.begin(grads, s, params, ok) for t, s in zip(self.transforms, state)]
        for name in list(grads):
            g = grads.pop(name).contiguous()
            for leaf, _ in links:
                g = leaf(name, g)
            _apply_leaf(params[name], g, ok)
            del g
        return [finish() for _, finish in links]


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
