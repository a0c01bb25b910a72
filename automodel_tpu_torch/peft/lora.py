"""LoRA / DoRA over the port's flat parameter dicts (counterpart of
``automodel_tpu/peft/lora.py``).

LoRA is a second dict beside the base parameters, named after the weights it adapts:
each matched weight ``W`` (``layers.wq``) gets ``layers.wq.lora_a`` (*stack, fan_in, r)
and ``layers.wq.lora_b`` (*stack, r, fan_out), and with DoRA ``layers.wq.magnitude``
(*stack, fan_out). The forward runs on :func:`merge_lora_params`'s dict, in which every
matched ``W`` is ``W + (alpha/r) A @ B`` (computed in f32, cast back to W's dtype), so
the model code is unchanged. The train step differentiates the adapter dict alone; the
base tensors are frozen (``requires_grad`` off), so the kernels' autograd functions
see ``needs_input_grad`` False for them and skip their weight gradients (linear CE's
dW, the grouped GEMM's tgmm), as JAX's jit drops the unused calls.

Matching reads the model's logical axes (``ParamModule.logical_axes()``): leading
``layers`` / ``expert`` dims stack independent matrices, fan-in ends after the first
body dim (after two for an attention output), norms, the embedding and
``(heads, head_dim)``-shaped biases never match. Patterns use the JAX package's
wildcards, and HF module names (``q_proj``) alias the port's leaf names.

DoRA: ``W' = m * (W + dW) / max(||W + dW||_col, 1e-6)``, ``m`` initialised to W's column
norms. Dropout (``dropout > 0``): one keep-mask over A's input rows a merge, rescaled by
1/(1 - p), drawn from a ``torch.Generator`` (the JAX package draws from
``fold_in(rng, crc32(path))``; the bits differ, the distribution is the same), or given
as ``keep_masks``. QLoRA: quantized base leaves (``quantization.qlora``) are dequantized
before the delta, and unmatched ones by a final sweep.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Callable, Sequence

import torch

__all__ = ["PeftConfig", "count_lora_params", "group_lora", "init_lora_params",
           "lora_merged_loss", "match_lora_paths", "merge_lora_params", "wildcard_match"]

# Reference YAMLs name HF modules (q_proj, ...); they match the port's leaf names
_HF_NAME_ALIASES = {
    "q_proj": "wq",
    "k_proj": "wk",
    "v_proj": "wv",
    "o_proj": "wo",
    "gate_proj": "w_gate",
    "up_proj": "w_up",
    "down_proj": "w_down",
    "linear_qkv": "wq|wk|wv",
    "linear_proj": "wo",
    "linear_fc1": "w_gate|w_up",
    "linear_fc2": "w_down",
}
# logical axes of leading dims that stack independent matrices
_STACK_AXES = ("layers", "expert")
# leaves that are never linear projections, whatever their shape
_NEVER_MATCH = ("embed",)
_FACTORS = ("lora_a", "lora_b", "magnitude")


@dataclasses.dataclass
class PeftConfig:
    """The ``peft`` section (JAX's PeftConfig, field for field)."""

    target_modules: list[str] = dataclasses.field(
        default_factory=lambda: ["*wq", "*wk", "*wv", "*wo", "*w_gate", "*w_up", "*w_down"])
    exclude_modules: list[str] = dataclasses.field(default_factory=list)
    match_all_linear: bool = False
    dim: int = 8
    alpha: int = 32
    use_dora: bool = False
    dropout: float = 0.0  # one mask over A's input rows per merge (see the module doc)
    lora_A_init: str = "xavier"  # "xavier" | "uniform" | "gaussian"
    lora_dtype: str | None = None  # None: each base weight's dtype

    def __post_init__(self):
        if isinstance(self.target_modules, str):
            self.target_modules = [self.target_modules]
        if isinstance(self.exclude_modules, str):
            self.exclude_modules = [self.exclude_modules]
        if not 0.0 <= self.dropout < 1.0:
            raise ValueError(f"lora dropout must be in [0, 1), got {self.dropout}")

    @property
    def scaling(self) -> float:
        return self.alpha / self.dim

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "PeftConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


def wildcard_match(pattern: str, key: str | None) -> bool | None:
    """'*' spans any characters; the whole key must match."""
    if key is None:
        return None
    regex = re.compile("^" + re.escape(pattern).replace(r"\*", "(.*)") + "$")
    return regex.match(key) is not None


def _normalize_patterns(patterns: Sequence[str]) -> list[str]:
    out = []
    for p in patterns:
        leafname = p.split(".")[-1]
        alias = _HF_NAME_ALIASES.get(leafname)
        if alias is not None:
            prefix = p[: len(p) - len(leafname)]
            out.extend(prefix + a for a in alias.split("|"))
        else:
            out.append(p)
    # bare module names ("q_proj") mean "anywhere in the tree"
    return [p if p.startswith("*") or "." in p else "*" + p for p in out]


def _leaf_structure(path: str, axes: tuple) -> tuple[int, int] | None:
    """(n_stack, split) of a LoRA-able weight, or None when it is no linear weight."""
    name = path.split(".")[-1]
    n_stack = 0
    while n_stack < len(axes) and axes[n_stack] in _STACK_AXES:
        n_stack += 1
    body = axes[n_stack:]
    if len(body) < 2 or name in _NEVER_MATCH or any(a == "norm" for a in body):
        return None
    split = 2 if body[0] in ("heads", "kv_heads") else 1
    if split >= len(body):  # a (heads, head_dim) bias: no fan-out dims
        return None
    return n_stack, n_stack + split


def _flatten_axes(axes_tree: Any, prefix: str = "") -> list[tuple[str, tuple | None]]:
    """Flat or nested axes dicts -> [(dotted name, axes)]."""
    out = []
    if isinstance(axes_tree, dict):
        for k, v in axes_tree.items():
            out.extend(_flatten_axes(v, f"{prefix}{k}."))
    else:
        out.append((prefix[:-1], axes_tree))
    return out


def match_lora_paths(logical_axes: Any, cfg: PeftConfig) -> dict[str, tuple[int, int]]:
    """Weights LoRA adapts -> (n_stack_dims, split_index). ``match_all_linear`` takes
    every >= 2-d non-norm weight."""
    targets = _normalize_patterns(cfg.target_modules)
    excludes = _normalize_patterns(cfg.exclude_modules)
    matched: dict[str, tuple[int, int]] = {}
    for path, axes in _flatten_axes(logical_axes):
        if axes is None:
            continue
        struct = _leaf_structure(path, axes)
        if struct is None or any(wildcard_match(p, path) for p in excludes):
            continue
        if cfg.match_all_linear or any(wildcard_match(p, path) for p in targets):
            matched[path] = struct
    return matched


def init_lora_params(params: dict, logical_axes: Any, cfg: PeftConfig,
                     generator: torch.Generator, dtype: torch.dtype | None = None
                     ) -> dict[str, torch.Tensor]:
    """The adapter dict: A per ``lora_A_init``, B zeros (so step 0 is the base model),
    DoRA's magnitude W's column norms. Weights in sorted order, each A drawn in f32 from
    ``generator`` on the weight's device. dtype: ``dtype`` > ``cfg.lora_dtype`` > the
    weight's own."""
    if dtype is None and cfg.lora_dtype is not None:
        dtype = getattr(torch, cfg.lora_dtype)
    matched = match_lora_paths(logical_axes, cfg)
    if not matched:
        names = [p for p, _ in _flatten_axes(logical_axes)][:20]
        raise ValueError(f"peft matched no params; target_modules={cfg.target_modules} "
                         f"available={names}...")
    lora: dict[str, torch.Tensor] = {}
    for path, (n_stack, split) in sorted(matched.items()):
        w = params[path]
        leaf_dtype = w.dtype if dtype is None else dtype
        stack = tuple(w.shape[:n_stack])
        fan_in, fan_out = math.prod(w.shape[n_stack:split]), math.prod(w.shape[split:])
        r = cfg.dim
        shape = (*stack, fan_in, r)
        kw = dict(generator=generator, device=w.device, dtype=torch.float32)
        if cfg.lora_A_init == "xavier":
            limit = math.sqrt(6.0 / (fan_in + r))
            a = torch.rand(shape, **kw) * (2 * limit) - limit
        elif cfg.lora_A_init == "uniform":
            limit = 1.0 / math.sqrt(fan_in)
            a = torch.rand(shape, **kw) * (2 * limit) - limit
        else:  # gaussian
            a = torch.randn(shape, **kw) / math.sqrt(fan_in)
        lora[f"{path}.lora_a"] = a.to(leaf_dtype)
        lora[f"{path}.lora_b"] = torch.zeros((*stack, r, fan_out), dtype=leaf_dtype,
                                             device=w.device)
        if cfg.use_dora:
            w2 = w.detach().reshape(*stack, fan_in, fan_out).float()
            lora[f"{path}.magnitude"] = torch.linalg.vector_norm(w2, dim=-2).to(leaf_dtype)
    return lora


def group_lora(lora: dict[str, torch.Tensor]) -> dict[str, dict[str, torch.Tensor]]:
    """``{"layers.wq.lora_a": a, ...}`` -> ``{"layers.wq": {"lora_a": a, ...}}``, sorted."""
    out: dict[str, dict[str, torch.Tensor]] = {}
    for name in sorted(lora):
        path, _, leaf = name.rpartition(".")
        if leaf not in _FACTORS:
            raise KeyError(f"not a LoRA tensor name: {name!r}")
        out.setdefault(path, {})[leaf] = lora[name]
    return out


def merge_lora_params(params: dict, lora: dict[str, torch.Tensor], cfg: PeftConfig,
                      generator: torch.Generator | None = None,
                      keep_masks: dict[str, torch.Tensor] | None = None) -> dict:
    """A new dict in which every adapted weight is ``W + (alpha/r) A @ B`` (DoRA:
    renormalised and scaled by the magnitude) in W's dtype, and every quantized leaf is
    dense; the rest are the base's own tensors. Differentiable in the adapter.

    Dropout (``cfg.dropout > 0``) applies when a ``generator`` (training) or
    ``keep_masks`` (path -> bool mask of A's shape without its rank dim) is given."""
    from automodel_tpu_torch.quantization.qlora import (dequantize_leaf, dequantize_params,
                                                        is_quantized_leaf)

    out = dict(params)
    p = cfg.dropout
    for path, leaf in group_lora(lora).items():
        w = out[path]
        if is_quantized_leaf(w):
            w = dequantize_leaf(w)
        a, b = leaf["lora_a"], leaf["lora_b"]
        keep = None
        if p > 0.0 and keep_masks is not None:
            keep = keep_masks[path]
        elif p > 0.0 and generator is not None:
            keep = torch.rand(a.shape[:-1], generator=generator, device=a.device) < 1.0 - p
        if keep is not None:
            a = a * (keep.float() / (1.0 - p)).to(a.dtype)[..., None]
        delta = torch.matmul(a.float(), b.float()) * cfg.scaling
        merged = w.reshape(delta.shape).float() + delta
        if cfg.use_dora:
            col_norm = torch.linalg.vector_norm(merged, dim=-2, keepdim=True)
            merged = (leaf["magnitude"].float()[..., None, :] * merged
                      / torch.clamp_min(col_norm, 1e-6))
        out[path] = merged.reshape(w.shape).to(w.dtype)
    return dequantize_params(out)


def lora_merged_loss(core: Callable, get_base: Callable[[], dict],
                     lora: dict[str, torch.Tensor], cfg: PeftConfig,
                     generator: torch.Generator | None = None) -> Callable:
    """``f(*args) = core(merge_lora_params(get_base(), lora, cfg, generator), *args)``:
    the PEFT loss, merged (and its dropout mask drawn) at every call, so once a
    microbatch in the train step; ``get_base`` gives the frozen base (fake-quantized
    under QAT)."""
    def f(*args):
        return core(merge_lora_params(get_base(), lora, cfg, generator), *args)
    return f


def count_lora_params(lora: dict[str, torch.Tensor]) -> int:
    return sum(t.numel() for t in lora.values())
