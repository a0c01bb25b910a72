"""GPT-2 (counterpart of ``automodel_tpu/models/gpt2/model.py``, its training path).

Learned absolute positions (``wpe``), LayerNorm with a bias, the fused ``c_attn``
projection split in thirds into q, k and v, tanh GELU, and the unembedding tied to
``wte``. Parameters keep the JAX package's layout: HF's Conv1D weights are (in, out)
already, and the layer tensors are stacked along a leading (L, ...) axis.

The KV-cache decode branch and ``generate`` belong to generation, which the PyTorch
package has not ported: they raise NotImplementedError by name.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from automodel_tpu_torch.models.common.backend import BackendConfig
from automodel_tpu_torch.models.common.param_module import ParamModule
from automodel_tpu_torch.models.common.transformer import init_params, project
from automodel_tpu_torch.ops.attention import dot_product_attention
from automodel_tpu_torch.ops.norms import layer_norm

__all__ = ["GPT2Config", "GPT2LMHeadModel"]

# JAX GPT2LMHeadModel.logical_axes(), by the port's flat names
_LAYER_AXES = {
    "ln1_w": ("norm",), "ln1_b": ("norm",),
    "c_attn": ("embed", "mlp"), "c_attn_b": ("mlp",),
    "c_proj": ("mlp", "embed"), "c_proj_b": ("embed",),
    "ln2_w": ("norm",), "ln2_b": ("norm",),
    "c_fc": ("embed", "mlp"), "c_fc_b": ("mlp",),
    "c_proj2": ("mlp", "embed"), "c_proj2_b": ("embed",),
}
_TOP_AXES = {"wte": ("vocab", "embed"), "wpe": (None, "embed"), "lnf_w": ("norm",),
             "lnf_b": ("norm",)}
_GENERATION = ("GPT-2's KV-cache decoding belongs to generation, which is not ported to the "
               "PyTorch package yet (ROADMAP.md)")


@dataclasses.dataclass
class GPT2Config:
    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    layer_norm_epsilon: float = 1e-5
    initializer_range: float = 0.02

    @classmethod
    def from_hf(cls, hf: dict[str, Any]) -> "GPT2Config":
        return cls(vocab_size=hf["vocab_size"], n_positions=hf.get("n_positions", 1024),
                   n_embd=hf["n_embd"], n_layer=hf["n_layer"], n_head=hf["n_head"],
                   layer_norm_epsilon=hf.get("layer_norm_epsilon", 1e-5),
                   initializer_range=hf.get("initializer_range", 0.02))

    @property
    def num_hidden_layers(self) -> int:
        return self.n_layer

    @property
    def num_key_value_heads(self) -> int:
        return self.n_head  # MHA: GPT-2 predates GQA

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head

    def param_shapes(self) -> dict[str, tuple[int, ...]]:
        d, L = self.n_embd, self.n_layer
        layer = {"ln1_w": (d,), "ln1_b": (d,), "c_attn": (d, 3 * d), "c_attn_b": (3 * d,),
                 "c_proj": (d, d), "c_proj_b": (d,), "ln2_w": (d,), "ln2_b": (d,),
                 "c_fc": (d, 4 * d), "c_fc_b": (4 * d,), "c_proj2": (4 * d, d),
                 "c_proj2_b": (d,)}
        return {"wte": (self.vocab_size, d), "wpe": (self.n_positions, d),
                **{f"layers.{n}": (L, *s) for n, s in layer.items()},
                "lnf_w": (d,), "lnf_b": (d,)}


def init_gpt2_params(cfg: GPT2Config, generator: torch.Generator, dtype=torch.float32,
                     device=None) -> dict[str, torch.Tensor]:
    """JAX's init in distribution: normal(0, initializer_range) matrices, the two output
    projections scaled by 1 / sqrt(2L), ``wpe`` at std 0.01, LayerNorm weights 1 and
    every bias 0 (the values differ: the generators do)."""
    shapes = cfg.param_shapes()
    std = cfg.initializer_range
    out = {}
    for name, shape in shapes.items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf.endswith("_w"):
            out[name] = torch.ones(shape, dtype=dtype, device=device)
        elif leaf.endswith("_b"):
            out[name] = torch.zeros(shape, dtype=dtype, device=device)
        else:
            scale = {"wpe": 0.01, "c_proj": std / (2 * cfg.n_layer) ** 0.5,
                     "c_proj2": std / (2 * cfg.n_layer) ** 0.5}.get(leaf, std)
            out[name] = init_params({name: shape}, generator, scale, dtype, device)[name]
    return out


def gpt2_layer(cfg, backend, names, h, segment_ids, *weights):
    """One pre-norm block: h + c_proj(attn(ln_1(h))), then h + mlp(ln_2(h))."""
    dtype = backend.torch_dtype
    lp = {n: w.to(dtype) for n, w in zip(names, weights)}
    eps = cfg.layer_norm_epsilon
    b, s, d = h.shape
    x = layer_norm(h, lp["ln1_w"], lp["ln1_b"], eps)
    qkv = project(x, lp["c_attn"], 1) + lp["c_attn_b"]
    shape = (b, s, cfg.n_head, cfg.head_dim)
    # the thirds of the fused projection are strided views; the kernels take dense rows
    q, k, v = (t.reshape(shape).contiguous() for t in qkv.split(d, dim=-1))
    out = dot_product_attention(q, k, v, causal=True, segment_ids_q=segment_ids,
                                backend=backend.attention)
    h = h + (project(out.reshape(b, s, d), lp["c_proj"], 1) + lp["c_proj_b"])
    x = layer_norm(h, lp["ln2_w"], lp["ln2_b"], eps)
    act = F.gelu(project(x, lp["c_fc"], 1) + lp["c_fc_b"], approximate="tanh")
    return h + (project(act, lp["c_proj2"], 1) + lp["c_proj2_b"])


class GPT2LMHeadModel(ParamModule):
    """Holds the parameters (JAX layout, flat names) and runs GPT-2's forward."""

    config_class = GPT2Config

    def __init__(self, config: GPT2Config, backend: BackendConfig | None = None, *,
                 device: torch.device | str = "cuda", dtype=torch.float32,
                 generator: torch.Generator | None = None,
                 params: dict[str, torch.Tensor] | None = None):
        device = torch.device(device)
        if params is None and generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        super().__init__(params if params is not None
                         else init_gpt2_params(config, generator, dtype, device))
        self.config = config
        self.backend = backend or BackendConfig()

    @classmethod
    def from_config(cls, config: GPT2Config | dict, backend: BackendConfig | None = None,
                    **kw) -> "GPT2LMHeadModel":
        if isinstance(config, dict):
            config = GPT2Config.from_hf(config)
        return cls(config, backend, **kw)

    def logical_axes(self) -> dict[str, tuple]:
        return {name: (_TOP_AXES[name] if name in _TOP_AXES
                       else ("layers",) + _LAYER_AXES[name.split(".", 1)[1]])
                for name in self.config.param_shapes()}

    def state_dict_adapter(self):
        from automodel_tpu_torch.models.gpt2.state_dict_adapter import GPT2StateDictAdapter

        return GPT2StateDictAdapter(self.config)

    def forward(self, input_ids, positions=None, segment_ids=None, return_hidden=False,
                mesh=None, params=None, cache=None):
        """Logits (B, S, V) in the compute dtype through the tied ``wte``, or the final
        hidden states; ``params``: run on these tensors instead of the module's."""
        del mesh  # GPT-2 has no ring attention path, as in JAX
        if cache is not None:
            raise NotImplementedError(_GENERATION)
        cfg, backend = self.config, self.backend
        params = self.param_dict() if params is None else params
        dtype = backend.torch_dtype
        if positions is None:
            positions = torch.arange(input_ids.shape[1], device=input_ids.device).expand(
                input_ids.shape)
        h = (F.embedding(input_ids.long(), params["wte"].to(dtype))
             + F.embedding(positions.long(), params["wpe"].to(dtype)))
        names = list(_LAYER_AXES)
        per_layer = [params[f"layers.{n}"].unbind(0) for n in names]
        layer = backend.layer_remat(gpt2_layer)
        for i in range(cfg.n_layer):
            h = layer(cfg, backend, names, h, segment_ids, *(w[i] for w in per_layer))
        h = layer_norm(h, params["lnf_w"].to(dtype), params["lnf_b"].to(dtype),
                       cfg.layer_norm_epsilon)
        if return_hidden:
            return h
        return torch.matmul(h, params["wte"].to(dtype).t())

    def generate(self, *args, **kwargs):
        raise NotImplementedError(_GENERATION)
