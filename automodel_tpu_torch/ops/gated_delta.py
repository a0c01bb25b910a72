"""Gated DeltaNet linear attention, the chunked form Qwen3-Next's linear layers run
(counterpart of ``automodel_tpu/ops/gated_delta.py``; the math is transformers'
``torch_chunk_gated_delta_rule``).

Plain PyTorch ops: the JAX package runs no Pallas kernel here either. The intra-chunk
"UT transform", the inverse of the unit lower-triangular ``I + A``, is one batched
``torch.linalg.solve_triangular``; the inter-chunk recurrence is a loop over chunks that
carries each head's (dk, dv) state. Everything runs in f32 (the decays ``exp(g)``
underflow in bf16) and is cast back at the end. The decode helpers (``conv_step``,
``conv_state_from_prefill``) are not ported: the port has no generation yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["causal_conv1d", "chunk_gated_delta_rule", "gated_rms_norm", "l2norm"]


def l2norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """L2 normalisation over the last dim (FLA's, as transformers' Qwen3-Next)."""
    return x * torch.rsqrt((x * x).sum(-1, keepdim=True) + eps)


def causal_conv1d(x: torch.Tensor, weight: torch.Tensor, activation: str | None = "silu",
                  segment_ids: torch.Tensor | None = None,
                  bias: torch.Tensor | None = None) -> torch.Tensor:
    """Depthwise causal conv over the sequence: x (B, S, C), weight (C, K); output t sees
    inputs t-K+1 .. t (left zero padding, HF's ``causal_conv1d_fn``). With ``segment_ids``
    (B, S) the taps that reach into another packed document are zeroed (K shifted adds)."""
    k = weight.shape[-1]
    if segment_ids is not None:
        s = x.shape[1]
        y = x * weight[:, k - 1]
        for j in range(1, k):
            shifted = F.pad(x, (0, 0, j, 0))[:, :s]
            seg_shift = F.pad(segment_ids, (j, 0))[:, :s]
            same = (seg_shift == segment_ids)[..., None].to(x.dtype)
            y = y + shifted * same * weight[:, k - 1 - j]
    else:
        y = F.conv1d(F.pad(x.transpose(1, 2), (k - 1, 0)), weight[:, None, :],
                     groups=x.shape[-1]).transpose(1, 2)
    if bias is not None:
        y = y + bias
    if activation == "silu":
        return F.silu(y)
    if activation not in (None, "none"):
        raise NotImplementedError(f"conv activation {activation!r}")
    return y


def gated_rms_norm(x: torch.Tensor, weight: torch.Tensor, gate: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm(x) * w, gated by silu(gate), in f32 (Qwen3NextRMSNormGated: the norm
    before the gate)."""
    xf = x.float()
    out = weight.float() * (xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps))
    return (out * F.silu(gate.float())).to(x.dtype)


def chunk_gated_delta_rule(query: torch.Tensor, key: torch.Tensor, value: torch.Tensor,
                           g: torch.Tensor, beta: torch.Tensor, *, chunk_size: int = 64,
                           initial_state: torch.Tensor | None = None,
                           output_final_state: bool = False, use_qk_l2norm: bool = True):
    """The chunked gated delta rule, S_t = S_{t-1} exp(g_t) (I - b_t k_t k_t^T) + b_t k_t
    v_t^T and o_t = q_t^T S_t: query / key (B, S, H, dk), value (B, S, H, dv), g (B, S, H)
    the log decay (<= 0), beta (B, S, H) the write strength. Returns (out (B, S, H, dv)
    in query's dtype, the final (B, H, dk, dv) state or None)."""
    out_dtype = query.dtype
    b, s, h, dk = query.shape
    dv = value.shape[-1]
    if use_qk_l2norm:
        query, key = l2norm(query.float()), l2norm(key.float())
    q = query.float().transpose(1, 2) * dk**-0.5  # (B, H, S, d)
    k = key.float().transpose(1, 2)
    v = value.float().transpose(1, 2)
    gf = g.float().transpose(1, 2)
    bf = beta.float().transpose(1, 2)
    c = chunk_size
    pad = (-s) % c
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
        gf, bf = (F.pad(t, (0, pad)) for t in (gf, bf))
    n = (s + pad) // c
    q, k, v = (t.reshape(b, h, n, c, -1) for t in (q, k, v))
    gf, bf = gf.reshape(b, h, n, c), bf.reshape(b, h, n, c)
    k_beta, v_beta = k * bf[..., None], v * bf[..., None]
    gcs = gf.cumsum(-1)  # the log decay summed within each chunk
    # decay[i, j] = exp(gcs_i - gcs_j) for j <= i, else 0: the exponent is masked, not the
    # result (the upper triangle's is positive and overflows)
    tril = torch.ones(c, c, dtype=torch.bool, device=q.device).tril()
    strict = tril.tril(-1)
    decay = torch.exp((gcs[..., :, None] - gcs[..., None, :]).masked_fill(~tril, -torch.inf))
    # the UT transform, T = (I + A)^-1 with A = strict_tril(k_beta k^T * decay)
    a = (k_beta @ k.transpose(-1, -2) * decay).masked_fill(~strict, 0.0)
    eye = torch.eye(c, dtype=torch.float32, device=q.device)
    t_inv = torch.linalg.solve_triangular(eye + a, eye.expand_as(a), upper=False)
    v_new_c = t_inv @ v_beta
    k_cumdecay = t_inv @ (k_beta * gcs.exp()[..., None])
    attn_local = (q @ k.transpose(-1, -2) * decay).masked_fill(~tril, 0.0)
    state = (torch.zeros(b, h, dk, dv, dtype=torch.float32, device=q.device)
             if initial_state is None else initial_state.float())
    outs = []
    for i in range(n):
        g_i = gcs[:, :, i]
        v_new = v_new_c[:, :, i] - k_cumdecay[:, :, i] @ state
        inter = (q[:, :, i] * g_i.exp()[..., None]) @ state
        outs.append(inter + attn_local[:, :, i] @ v_new)
        g_last = g_i[..., -1]
        k_scaled = k[:, :, i] * (g_last[..., None] - g_i).exp()[..., None]
        state = state * g_last.exp()[..., None, None] + k_scaled.transpose(-1, -2) @ v_new
    out = torch.stack(outs, 2).reshape(b, h, n * c, dv)[:, :, :s]
    out = out.transpose(1, 2).to(out_dtype)
    return out, (state if output_final_state else None)
