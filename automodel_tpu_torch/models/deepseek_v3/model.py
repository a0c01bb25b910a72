"""The DeepSeek-V3 family (counterpart of ``automodel_tpu/models/deepseek_v3/model.py``).

Multi-head Latent Attention: queries come from the hidden state directly (``wq``,
``q_lora_rank`` null: DeepSeek-V2 / V2-Lite, Moonlight) or through a normed low-rank
latent (``wq_a``, ``q_a_norm``, ``wq_b``); keys and values come from a normed latent of
``kv_lora_rank`` (``wkv_a``, ``kv_a_norm``, ``wkv_b``), and a single-head rope stream
(the last ``qk_rope_head_dim`` columns of ``wkv_a``) is broadcast to every head. RoPE
is the interleaved (complex-pair) kind, on the rope sub-dimension only, and the softmax
scale carries YaRN's mscale^2. Keys are ``qk_nope_head_dim + qk_rope_head_dim`` wide,
values ``v_head_dim``: the flash kernels take equal widths, so attention runs the plain
path (as JAX's dispatch does), or the ring kernels under ``context_parallel: ring``.
MoE layers route with sigmoid noaux-tc scores, a correction bias and group-limited
selection (V2: softmax, greedy), with shared experts; the first
``first_k_dense_replace`` layers are dense. Kimi-K2, Moonlight and GLM-4-MoE-Lite
configs share the architecture.

Not ported: the decode cache and ``generate``, and V3.2's sparse indexer
(``bias_fn``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from automodel_tpu_torch.models.common.backend import checkpoint_name
from automodel_tpu_torch.models.common.logical_axes import MLA_LAYER_AXES
from automodel_tpu_torch.models.common.moe_transformer import MoECausalLM, MoEDecoderConfig
from automodel_tpu_torch.models.common.transformer import project
from automodel_tpu_torch.moe.config import MoEConfig
from automodel_tpu_torch.ops.attention import dot_product_attention
from automodel_tpu_torch.ops.norms import rms_norm
from automodel_tpu_torch.ops.rope import apply_rope_interleaved, rope_frequencies
from automodel_tpu_torch.parallel.ring_attention import make_ring_attention

__all__ = ["DeepseekV3Config", "DeepseekV3ForCausalLM", "make_mla_attention_fn",
           "mla_inv_freq"]


@dataclasses.dataclass
class DeepseekV3Config(MoEDecoderConfig):
    """The MoE decoder's config with MLA's widths; ``head_dim`` is the query / key width
    and every head has its own key (KH = H)."""

    q_lora_rank: int | None = None
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    def __post_init__(self):
        self.head_dim = self.qk_head_dim
        self.num_key_value_heads = self.num_attention_heads
        super().__post_init__()

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def softmax_scale(self) -> float:
        """qk_head_dim^-0.5 with YaRN's mscale^2 correction, as JAX's."""
        scale = self.qk_head_dim**-0.5
        rs = self.rope_scaling
        if rs and all(k in rs for k in ("factor", "mscale", "original_max_position_embeddings")):
            mscale = float(rs["mscale"])
            if self.max_position_embeddings > rs["original_max_position_embeddings"]:
                factor = float(rs["factor"])
                if factor > 1:
                    mscale = 0.1 * mscale * math.log(factor) + 1.0
            scale = scale * mscale * mscale
        return scale

    def attn_shapes(self) -> dict[str, tuple[int, ...]]:
        """MLA's projections and norms of one layer, named and ordered as JAX's
        ``_mla_shapes``."""
        d, n = self.hidden_size, self.num_attention_heads
        shapes: dict[str, tuple[int, ...]] = {"attn_norm": (d,), "mlp_norm": (d,)}
        if self.q_lora_rank is None:
            shapes["wq"] = (d, n, self.qk_head_dim)
        else:
            shapes |= {"wq_a": (d, self.q_lora_rank), "q_a_norm": (self.q_lora_rank,),
                       "wq_b": (self.q_lora_rank, n, self.qk_head_dim)}
        return shapes | {
            "wkv_a": (d, self.kv_lora_rank + self.qk_rope_head_dim),
            "kv_a_norm": (self.kv_lora_rank,),
            "wkv_b": (self.kv_lora_rank, n, self.qk_nope_head_dim + self.v_head_dim),
            "wo": (n, self.v_head_dim, d),
        }

    @classmethod
    def from_hf(cls, hf: dict[str, Any]) -> "DeepseekV3Config":
        """Build from an HF config.json dict, with the JAX package's reading of it: V3
        scores with sigmoid and the noaux-tc correction bias; V2 (``scoring_func``
        softmax, ``topk_method`` greedy / group_limited_greedy) softmaxes before top-k
        and has no bias."""
        scoring = hf.get("scoring_func", "sigmoid")
        topk_method = hf.get("topk_method", "noaux_tc")
        moe = MoEConfig(
            n_routed_experts=hf["n_routed_experts"],
            n_activated_experts=hf["num_experts_per_tok"],
            dim=hf["hidden_size"],
            moe_inter_dim=hf["moe_intermediate_size"],
            n_shared_experts=hf.get("n_shared_experts", 0),
            n_expert_groups=max(hf.get("n_group") or 1, 1),
            n_limited_groups=max(hf.get("topk_group") or 1, 1),
            gate_bias_update_factor=0.001 if topk_method == "noaux_tc" else 0.0,
            score_func=scoring,
            softmax_before_topk=scoring == "softmax",
            route_scale=hf.get("routed_scaling_factor", 1.0),
            norm_topk_prob=hf.get("norm_topk_prob", True),
        )
        return cls(
            vocab_size=hf["vocab_size"],
            hidden_size=hf["hidden_size"],
            intermediate_size=hf["intermediate_size"],
            num_hidden_layers=hf["num_hidden_layers"],
            num_attention_heads=hf["num_attention_heads"],
            q_lora_rank=hf.get("q_lora_rank"),
            kv_lora_rank=hf["kv_lora_rank"],
            qk_nope_head_dim=hf["qk_nope_head_dim"],
            qk_rope_head_dim=hf["qk_rope_head_dim"],
            v_head_dim=hf["v_head_dim"],
            first_k_dense_replace=_first_k_dense(hf),
            max_position_embeddings=hf.get("max_position_embeddings", 4096),
            rope_theta=hf.get("rope_theta", 10000.0),
            rope_scaling=hf.get("rope_scaling"),
            rms_norm_eps=hf.get("rms_norm_eps", 1e-6),
            tie_word_embeddings=hf.get("tie_word_embeddings", False),
            initializer_range=hf.get("initializer_range", 0.02),
            moe=moe,
        )


def _first_k_dense(hf: dict[str, Any]) -> int:
    """``first_k_dense_replace``, or the dense prefix of GLM-4-MoE-Lite's
    ``mlp_layer_types`` (["dense", "sparse", ...]); other interleavings raise."""
    layer_types = hf.get("mlp_layer_types")
    if layer_types:
        flags = [t == "sparse" for t in layer_types]
        first = flags.index(True) if any(flags) else len(flags)
        if not all(flags[first:]):
            raise NotImplementedError("non-prefix dense/sparse interleavings are not supported")
        return first
    return hf.get("first_k_dense_replace", 0)


def mla_inv_freq(cfg: DeepseekV3Config, device=None) -> torch.Tensor:
    """RoPE frequencies of the rope sub-dimension: YaRN's only when training runs past
    the original context (``max_position_embeddings`` above the scaling's
    ``original_max_position_embeddings``), as JAX's."""
    rs = cfg.rope_scaling
    use_yarn = bool(
        rs
        and all(k in rs for k in ("factor", "beta_fast", "beta_slow",
                                  "original_max_position_embeddings"))
        and cfg.max_position_embeddings > rs["original_max_position_embeddings"])
    return rope_frequencies(cfg.qk_rope_head_dim, cfg.rope_theta,
                            dict(rs, rope_type="yarn") if use_yarn else None, device=device)


def make_mla_attention_fn(cfg: DeepseekV3Config, backend, device=None):
    """MLA as the MoE decoder's ``attention_fn`` (training form). The named saves sit
    where JAX's are: ``attn_q`` on q after RoPE, ``attn_k`` on k with the rope stream
    broadcast, ``attn_v`` on v. With ``context_parallel: ring`` and a mesh whose cp axis
    is larger than 1, attention is ring attention over cp at DeepSeek's softmax scale
    (Dv != D: the ring kernels' (192, 128) instantiation at DeepSeek's widths)."""
    inv_freq = mla_inv_freq(cfg, device)
    nope, rope_dim = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim

    def mla_attention(lp, x, positions, segment_ids, window, rope, mesh):
        del window, rope  # MLA has no sliding layers and its own RoPE
        if cfg.q_lora_rank is None:
            q = project(x, lp["wq"], 1)
        else:
            q_latent = rms_norm(project(x, lp["wq_a"], 1), lp["q_a_norm"], cfg.rms_norm_eps)
            q = project(q_latent, lp["wq_b"], 1)
        q_nope, q_pe = q.split([nope, rope_dim], dim=-1)
        kv = project(x, lp["wkv_a"], 1)
        c_kv, k_pe = kv.split([cfg.kv_lora_rank, rope_dim], dim=-1)
        c_kv = rms_norm(c_kv, lp["kv_a_norm"], cfg.rms_norm_eps)
        q_pe = apply_rope_interleaved(q_pe, positions, inv_freq)
        k_pe = apply_rope_interleaved(k_pe[:, :, None, :], positions, inv_freq)
        q = checkpoint_name(torch.cat([q_nope, q_pe], dim=-1), "attn_q")
        k_nope, v = project(c_kv, lp["wkv_b"], 1).split([nope, cfg.v_head_dim], dim=-1)
        k = checkpoint_name(torch.cat([k_nope, k_pe.expand(*k_nope.shape[:-1], rope_dim)],
                                      dim=-1), "attn_k")
        v = checkpoint_name(v, "attn_v")
        if backend.context_parallel == "ring" and mesh is not None and mesh.cp > 1:
            ring = make_ring_attention(mesh, causal=True, softmax_scale=cfg.softmax_scale)
            out = ring(q, k, v, positions, segment_ids)
        else:
            out = dot_product_attention(q, k, v, causal=True, segment_ids_q=segment_ids,
                                        softmax_scale=cfg.softmax_scale,
                                        backend=backend.attention)
        return project(out, lp["wo"], 2)

    return mla_attention


class DeepseekV3ForCausalLM(MoECausalLM):
    """Random init, the MoE decoder's forward with MLA, and the HF adapter with
    DeepSeek's names (``e_score_correction_bias`` kept in f32)."""

    config_class = DeepseekV3Config
    layer_axes = MLA_LAYER_AXES

    def attention_fn(self, device):
        return make_mla_attention_fn(self.config, self.backend, device)

    def state_dict_adapter(self):
        from automodel_tpu_torch.models.deepseek_v3.state_dict_adapter import (
            DeepseekV3StateDictAdapter)

        return DeepseekV3StateDictAdapter(self.config)
