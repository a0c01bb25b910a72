"""GQA + MoE decoder, training path (counterpart of
``automodel_tpu/models/common/moe_transformer.py``).

A model may have a dense prefix (``first_k_dense_replace`` layers with the dense MLP,
stacked under ``dense_layers.``); the MoE layers follow, stacked under ``moe_layers.``
with their MoE block under ``moe_layers.moe.``. The forward returns ``(out, stats)``
with the summed ``aux_loss`` (or None) and the per-layer ``expert_load`` (L_moe, E).
Each layer attends with its own sliding window (``transformer.layer_windows``: the
window on a "sliding_attention" layer, None on a full one).

A family with another attention (DeepSeek's MLA) plugs in two hooks, as the JAX
package's ``attn_shapes`` and ``attention_fn``: its config's :meth:`MoEDecoderConfig.attn_shapes`
gives the attention parameters of every layer (the dense prefix's and the MoE
stack's), and the forward's ``attention_fn(lp, x, positions, segment_ids, window, rope,
mesh)`` computes a layer's attention from them. The defaults are the GQA block.

  dense_layers: the dense decoder's layer table (``transformer.layer_shapes``)
  moe_layers:   the same minus w_gate/w_up/w_down, plus moe.gate.weight (L,E,D)
                | moe.experts.gate_up_proj (L,E,D,2I) | moe.experts.down_proj (L,E,I,D)
                | [router / expert biases, shared experts]
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from automodel_tpu_torch.models.common.backend import BackendConfig
from automodel_tpu_torch.models.common.param_module import ParamModule
from automodel_tpu_torch.models.common.transformer import (
    DenseDecoderConfig, attention_block, init_params, layer_shapes, layer_windows, mlp_block,
    resolve_unembed)
from automodel_tpu_torch.moe.config import MoEConfig
from automodel_tpu_torch.moe.dispatch import make_moe_block_forward
from automodel_tpu_torch.moe.layers import (cast_moe_compute_params, moe_param_shapes,
                                            nest_moe_params)
from automodel_tpu_torch.ops.norms import rms_norm
from automodel_tpu_torch.ops.rope import rope_attention_scaling, rope_frequencies, rope_tables

__all__ = ["MoECausalLM", "MoEDecoderConfig", "gqa_attention_fn", "moe_decoder_forward",
           "moe_decoder_param_shapes"]

_DENSE_MLP = ("w_gate", "w_up", "w_down")


@dataclasses.dataclass
class MoEDecoderConfig(DenseDecoderConfig):
    """GQA decoder whose layers from ``first_k_dense_replace`` on use an MoE block."""

    moe: MoEConfig | None = None
    first_k_dense_replace: int = 0

    def __post_init__(self):
        super().__post_init__()
        if self.moe is None:
            raise ValueError("MoEDecoderConfig requires a MoEConfig in .moe")

    @property
    def num_moe_layers(self) -> int:
        return self.num_hidden_layers - self.first_k_dense_replace

    def attn_shapes(self) -> dict[str, tuple[int, ...]]:
        """A layer's attention parameters and its two norms (without the stacked L axis):
        the GQA block's here; a family with another attention overrides it."""
        return {n: s for n, s in layer_shapes(self).items() if n not in _DENSE_MLP}

    def param_shapes(self) -> dict[str, tuple[int, ...]]:
        return moe_decoder_param_shapes(self)


def moe_decoder_param_shapes(cfg: MoEDecoderConfig) -> dict[str, tuple[int, ...]]:
    """Flat name -> shape of every parameter, named as the JAX tree flattens them: the
    dense prefix takes the config's attention shapes and the dense MLP, the MoE stack
    the attention shapes and the MoE block."""
    shapes = {"embed": (cfg.vocab_size, cfg.hidden_size), "final_norm": (cfg.hidden_size,)}
    attn = cfg.attn_shapes()
    k = cfg.first_k_dense_replace
    if k > 0:
        d, i = cfg.hidden_size, cfg.intermediate_size
        dense = attn | {"w_gate": (d, i), "w_up": (d, i), "w_down": (i, d)}
        shapes |= {f"dense_layers.{n}": (k, *s) for n, s in dense.items()}
    lm = cfg.num_moe_layers
    shapes |= {f"moe_layers.{n}": (lm, *s) for n, s in attn.items()}
    shapes |= {f"moe_layers.moe.{n}": (lm, *s) for n, s in moe_param_shapes(cfg.moe).items()}
    if not cfg.tie_word_embeddings:
        shapes["lm_head"] = (cfg.hidden_size, cfg.vocab_size)
    return shapes


def gqa_attention_fn(cfg, backend):
    """The default ``attention_fn``: the GQA block of ``transformer.attention_block`` with
    the forward's RoPE tables ``rope``."""
    def attention(lp, x, positions, segment_ids, window, rope, mesh):
        return attention_block(cfg, backend, lp, x, positions, segment_ids, mesh=mesh,
                               rope=rope, window=window)
    return attention


def _dense_layer(cfg, backend, attention_fn, names, h, positions, segment_ids, rope, mesh,
                 window, *weights):
    """One layer of the dense prefix: h + attn(norm(h)), then + mlp(norm(h))."""
    dtype = backend.torch_dtype
    lp = {n: w.to(dtype) for n, w in zip(names, weights)}
    x = rms_norm(h, lp["attn_norm"], cfg.rms_norm_eps)
    h = h + attention_fn(lp, x, positions, segment_ids, window, rope, mesh)
    return h + mlp_block(cfg, lp, rms_norm(h, lp["mlp_norm"], cfg.rms_norm_eps))


def _moe_layer(cfg, backend, moe_block, attention_fn, attn_names, moe_names, h, positions,
               segment_ids, token_mask, rope, mesh, window, *weights):
    """One MoE layer: h + attn(norm(h)), then + moe(norm(h)). Returns (h, aux, load);
    ``rope`` is the forward's ``rope_tables`` (None with a family's attention), ``window``
    the layer's sliding window."""
    dtype = backend.torch_dtype
    n_attn = len(attn_names)
    lp = {n: w.to(dtype) for n, w in zip(attn_names, weights[:n_attn])}
    moe_params = cast_moe_compute_params(nest_moe_params(dict(zip(moe_names, weights[n_attn:]))),
                                         dtype)
    x = rms_norm(h, lp["attn_norm"], cfg.rms_norm_eps)
    h = h + attention_fn(lp, x, positions, segment_ids, window, rope, mesh)
    x = rms_norm(h, lp["mlp_norm"], cfg.rms_norm_eps)
    y, aux, load, _ = moe_block(moe_params, x, token_mask)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return h + y, aux, load


def moe_decoder_forward(
    cfg: MoEDecoderConfig,
    backend: BackendConfig,
    params: dict[str, torch.Tensor],
    input_ids: torch.Tensor,  # (B, S)
    positions: torch.Tensor | None = None,
    segment_ids: torch.Tensor | None = None,
    token_mask: torch.Tensor | None = None,  # (B, S) True = valid (counts for routing)
    return_hidden: bool = False,
    training: bool = True,
    mesh=None,
    attention_fn=None,
) -> tuple[torch.Tensor, dict[str, Any]]:
    """``(logits or hidden, stats)``; stats: ``aux_loss`` (summed over MoE layers, or
    None when the aux loss is off) and ``expert_load`` (L_moe, E). ``mesh`` as for
    ``transformer.decoder_forward``. ``attention_fn``: a family's attention (see the
    module docstring), or None for the GQA block."""
    dtype = backend.torch_dtype
    if positions is None:
        positions = torch.arange(input_ids.shape[1], device=input_ids.device).expand(
            input_ids.shape)
    rope = None
    if attention_fn is None:
        inv_freq = rope_frequencies(cfg.head_dim, cfg.rope_theta, cfg.rope_scaling,
                                    cfg.partial_rotary_factor, device=input_ids.device)
        rope = rope_tables(positions, inv_freq, rope_attention_scaling(cfg.rope_scaling))
        attention_fn = gqa_attention_fn(cfg, backend)
    emit_aux = cfg.moe.aux_loss_coeff > 0 and training and not backend.fake_balanced_gate
    h = F.embedding(input_ids.long(), params["embed"].to(dtype))

    attn_names = list(cfg.attn_shapes())
    dense_names = [*attn_names, *_DENSE_MLP]
    dense = [params[f"dense_layers.{n}"].unbind(0) for n in dense_names] \
        if cfg.first_k_dense_replace > 0 else []
    windows = layer_windows(cfg)
    dense_layer = backend.layer_remat(_dense_layer)
    for i in range(cfg.first_k_dense_replace):
        h = dense_layer(cfg, backend, attention_fn, dense_names, h, positions, segment_ids,
                        rope, mesh, windows[i], *[w[i] for w in dense])

    moe_block = make_moe_block_forward(cfg.moe, backend, training=training)
    moe_names = list(moe_param_shapes(cfg.moe))
    per_layer = ([params[f"moe_layers.{n}"].unbind(0) for n in attn_names]
                 + [params[f"moe_layers.moe.{n}"].unbind(0) for n in moe_names])
    auxs, loads = [], []
    moe_layer = backend.layer_remat(_moe_layer)
    for i in range(cfg.num_moe_layers):
        h, aux, load = moe_layer(cfg, backend, moe_block, attention_fn, attn_names, moe_names,
                                 h, positions, segment_ids, token_mask, rope, mesh,
                                 windows[cfg.first_k_dense_replace + i],
                                 *[w[i] for w in per_layer])
        auxs.append(aux)
        loads.append(load)

    h = rms_norm(h, params["final_norm"].to(dtype), cfg.rms_norm_eps)
    stats = {"aux_loss": torch.stack(auxs).sum() if emit_aux else None,
             "expert_load": torch.stack(loads)}
    if return_hidden:
        return h, stats
    return torch.matmul(h, resolve_unembed(cfg, params, dtype)), stats


class MoECausalLM(ParamModule):
    """Holds the parameters of an MoE decoder family (JAX layout, flat names) and runs
    :func:`moe_decoder_forward`; the forward returns ``(logits or hidden, stats)``. A
    family sets ``config_class`` (with its ``from_hf``) and ``state_dict_adapter``."""

    config_class = MoEDecoderConfig

    def __init__(self, config: MoEDecoderConfig, backend: BackendConfig | None = None, *,
                 device: torch.device | str = "cuda", dtype=torch.float32,
                 generator: torch.Generator | None = None,
                 params: dict[str, torch.Tensor] | None = None):
        """Random weights from ``generator`` (seed 0 by default), or ``params`` as given
        (``models/auto.py`` passes a checkpoint's, already on their device)."""
        device = torch.device(device)
        if params is None and generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        super().__init__(params if params is not None
                         else init_params(moe_decoder_param_shapes(config), generator,
                                          config.initializer_range, dtype, device))
        self.config = config
        self.backend = backend or BackendConfig()

    @classmethod
    def from_config(cls, config, backend: BackendConfig | None = None, **kw):
        """From a config object or an HF config.json dict."""
        if isinstance(config, dict):
            config = cls.config_class.from_hf(config)
        return cls(config, backend, **kw)

    def attention_fn(self, device):
        """The family's ``attention_fn`` for a forward on ``device``; None: the GQA block."""
        return None

    def forward(self, input_ids, positions=None, segment_ids=None, token_mask=None,
                return_hidden=False, training=True, mesh=None, params=None):
        """``params``: run on these tensors instead of the module's (a LoRA merge)."""
        return moe_decoder_forward(self.config, self.backend,
                                   self.param_dict() if params is None else params, input_ids,
                                   positions=positions, segment_ids=segment_ids,
                                   token_mask=token_mask, return_hidden=return_hidden,
                                   training=training, mesh=mesh,
                                   attention_fn=self.attention_fn(input_ids.device))
