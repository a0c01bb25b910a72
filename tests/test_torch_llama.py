"""The port's Llama against the JAX package's: a tiny config (vocab 128, hidden 64,
2 layers, 4 heads, 2 kv heads), weights built once in JAX and carried across with
params_from_jax. Logits agree to rtol = atol = 1e-4 (f32): the port's flash path
(the kernels' plain version on the CPU) against JAX's Pallas kernel in interpret
mode, and the two einsum paths against each other. The remat ladder: under each
policy the loss and every gradient equal "full" (rtol 1e-5, atol 1e-6) and JAX's under
the same policy (atol 1e-4, f32), and the matmuls a backward replays equal JAX's,
counted on both sides (:class:`MatmulCounter`, :func:`jax_matmul_counts`)."""

import contextlib
import math
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from automodel_tpu.models.common.backend import BackendConfig as JaxBackend
from automodel_tpu.models.llama.model import LlamaForCausalLM as JaxLlama
from automodel_tpu_torch.models.common.backend import REMAT_POLICIES, BackendConfig
from automodel_tpu_torch.ops import flash_attention as tfa
from automodel_tpu_torch.models.llama.convert import params_from_jax
from automodel_tpu_torch.models.llama.model import LlamaConfig, LlamaForCausalLM
from tests.torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

HF = dict(architectures=["LlamaForCausalLM"], vocab_size=128, hidden_size=64,
          intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
          num_key_value_heads=2, max_position_embeddings=256,
          rope_scaling={"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
                        "high_freq_factor": 4.0, "original_max_position_embeddings": 64})


def _jax_params(hf, seed=0):
    model = JaxLlama.from_config(hf, JaxBackend(dtype="float32", remat_policy="full"))
    return jax.device_get(model.init(jax.random.key(seed)))


def _batch(seed=0, b=2, s=32):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 128, (b, s)).astype(np.int32)
    seg = np.ones((b, s), np.int32)
    seg[0, s // 2:] = 2  # two packed sequences in row 0
    seg[1, s - 6:] = 0  # right padding in row 1
    pos = np.concatenate([np.arange(s // 2), np.arange(s // 2)])[None].repeat(b, 0)
    pos[1] = np.arange(s)
    return ids, pos.astype(np.int32), seg


def _logits_pair(hf, jax_attention, torch_attention, segments=True):
    params = _jax_params(hf)
    ids, pos, seg = _batch()
    jm = JaxLlama.from_config(hf, JaxBackend(dtype="float32", remat_policy="full",
                                             attention=jax_attention))
    want = np.asarray(jm(params, jnp.asarray(ids), positions=jnp.asarray(pos),
                         segment_ids=jnp.asarray(seg) if segments else None))
    tm = LlamaForCausalLM.from_config(hf, BackendConfig(dtype="float32", attention=torch_attention,
                                                        remat_policy="mlp_attn_dots"),
                                      device="cpu")
    tm.load_params(params_from_jax(params, tm.config))
    got = tm(torch.tensor(ids), positions=torch.tensor(pos),
             segment_ids=torch.tensor(seg) if segments else None).detach().numpy()
    return got, want


@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
def test_flash_logits_match_pallas_interpret(tied):
    got, want = _logits_pair(dict(HF, tie_word_embeddings=tied), "flash_interpret", "flash")
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("segments", [True, False], ids=["segments", "no_segments"])
def test_xla_logits_match(segments):
    got, want = _logits_pair(HF, "xla", "xla", segments=segments)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_remat_changes_no_value():
    """Per-layer checkpointing (every policy but "full") gives the same loss and grads."""
    params = params_from_jax(_jax_params(HF), LlamaConfig.from_hf(HF))
    ids, pos, seg = (torch.tensor(a) for a in _batch())
    out = {}
    for policy in ("full", "mlp_attn_dots"):
        m = LlamaForCausalLM.from_config(HF, BackendConfig(dtype="float32", attention="flash",
                                                           remat_policy=policy), device="cpu")
        m.load_params(params)
        loss = m(ids, positions=pos, segment_ids=seg).float().square().mean()
        out[policy] = torch.autograd.grad(loss, list(m.param_dict().values()))
    for a, b in zip(out["full"], out["mlp_attn_dots"]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_backend_validates_remat_names():
    with pytest.raises(ValueError, match="remat_policy"):
        BackendConfig(remat_policy="bogus")
    assert not BackendConfig(remat_policy="full").checkpoint_layers
    assert BackendConfig(remat_policy="none").checkpoint_layers


def test_params_from_jax_checks_the_tree():
    cfg = LlamaConfig.from_hf(HF)
    params = _jax_params(HF)
    flat = params_from_jax(params, cfg)
    assert flat["layers.wq"].shape == (2, 64, 4, 16)
    bad = dict(params, layers=dict(params["layers"], wq=np.zeros((2, 64, 4, 8), np.float32)))
    with pytest.raises(ValueError, match="layers.wq"):
        params_from_jax(bad, cfg)
    with pytest.raises(KeyError):
        params_from_jax({k: v for k, v in params.items() if k != "final_norm"}, cfg)
    bf16 = jax.device_get(jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params))
    t = params_from_jax(bf16, cfg)["embed"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), np.asarray(bf16["embed"], np.float32))


def _matmul_key(m, k, n):
    """A matmul without batch dims by its output's sides (either order: the two packages
    orient the dW products differently) and its contracted size."""
    return (min(m, n), max(m, n), k)


class MatmulCounter(TorchDispatchMode):
    """Counts the matmuls without batch dims that run (``aten.mm`` / ``addmm``) while it is
    active, by :func:`_matmul_key`; a saved op that a replay takes from the cache does not
    run, so it is not counted. ``paused`` stops the count (inside a kernel's stand-in)."""

    _ARGS = {torch.ops.aten.mm.default: (0, 1), torch.ops.aten.addmm.default: (1, 2)}

    def __init__(self):
        super().__init__()
        self.counts = Counter()
        self.paused = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self._ARGS and not self.paused:
            a, b = (args[i] for i in self._ARGS[func])
            self.counts[_matmul_key(a.shape[0], a.shape[1], b.shape[1])] += 1
        return func(*args, **(kwargs or {}))


def jax_matmul_counts(closed_jaxpr):
    """(the dot_generals without batch dims of a jaxpr, by :func:`_matmul_key`, outside
    the Pallas kernels' bodies; the number of pallas_calls)."""
    counts, calls = Counter(), 0

    def walk(jaxpr):
        nonlocal calls
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "pallas_call":
                calls += 1
                continue
            if eqn.primitive.name == "dot_general":
                (lc, _), (lb, rb) = eqn.params["dimension_numbers"]
                if not lb and not rb:
                    ls, rs = (v.aval.shape for v in eqn.invars[:2])
                    k = math.prod(ls[i] for i in lc)
                    counts[_matmul_key(math.prod(ls) // k, k, math.prod(rs) // k)] += 1
            for p in eqn.params.values():
                for sub in p if isinstance(p, (list, tuple)) else (p,):
                    inner = getattr(sub, "jaxpr", sub)
                    if hasattr(inner, "eqns"):
                        walk(inner)

    walk(closed_jaxpr.jaxpr)
    return counts, calls


REMAT_HF = dict(HF, num_hidden_layers=1)


def _remat_loss_and_grads(policy, params, ids, count=False, monkeypatch=None):
    """The port's loss (mean square of the logits) and gradients under ``policy``, and,
    with ``count``, the matmuls of its forward and backward and the calls of flash's
    plain version (the kernel's stand-in: the forward and each replay)."""
    m = LlamaForCausalLM.from_config(REMAT_HF, BackendConfig(dtype="float32", attention="flash",
                                                             remat_policy=policy), device="cpu")
    m.load_params(params_from_jax(params, m.config))
    calls = []
    if count:
        plain = tfa.flash_attention_reference
        monkeypatch.setattr(tfa, "flash_attention_reference",
                            lambda *a, **k: calls.append(1) or plain(*a, **k))
    with MatmulCounter() if count else contextlib.nullcontext() as counter:
        loss = m(torch.tensor(ids)).square().mean()
        grads = torch.autograd.grad(loss, list(m.param_dict().values()))
    return loss, dict(zip(m.param_dict(), grads)), (counter.counts if count else None), len(calls)


def _jax_remat(policy, params, ids):
    jm = JaxLlama.from_config(REMAT_HF, JaxBackend(dtype="float32", remat_policy=policy,
                                                   attention="flash_interpret"))
    return jm, lambda p: jnp.mean(jnp.square(jm(p, jnp.asarray(ids))))


@pytest.mark.parametrize("policy", REMAT_POLICIES)
def test_remat_policy_matches_full_and_jax(policy):
    """Every policy gives the loss and gradients of "full" and of JAX's same policy."""
    params = _jax_params(REMAT_HF)
    ids = np.random.RandomState(1).randint(0, 128, (2, 32)).astype(np.int32)
    loss, grads, _, _ = _remat_loss_and_grads(policy, params, ids)
    loss_full, grads_full, _, _ = _remat_loss_and_grads("full", params, ids)
    torch.testing.assert_close(loss, loss_full, rtol=1e-5, atol=1e-6)
    for name, g in grads.items():
        torch.testing.assert_close(g, grads_full[name], rtol=1e-5, atol=1e-6)
    _, jloss = _jax_remat(policy, params, ids)
    want_loss, want = jax.value_and_grad(jloss)(params)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=0, atol=1e-4)
    want = params_from_jax(jax.device_get(want), LlamaConfig.from_hf(REMAT_HF))
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=0, atol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("policy", ["none", "dots", "mlp_dots", "mlp_attn_dots"])
def test_remat_replays_the_matmuls_jax_replays(policy, monkeypatch):
    """The matmuls of the forward and backward (so the forward, the replay and the
    gradients) equal the dot_generals of JAX's grad under the same policy, outside the
    Pallas kernels; flash's stand-in runs once more than the forward (the replay) where
    JAX's forward kernel does (its pallas_calls: forward, replay, backward)."""
    params = _jax_params(REMAT_HF)
    ids = np.random.RandomState(1).randint(0, 128, (2, 32)).astype(np.int32)
    _, _, counts, flash_calls = _remat_loss_and_grads(policy, params, ids, True, monkeypatch)
    _, jloss = _jax_remat(policy, params, ids)
    want, pallas_calls = jax_matmul_counts(jax.make_jaxpr(jax.grad(jloss))(params))
    assert counts == want
    assert flash_calls + 1 == pallas_calls == 3
    # against "full": the replayed projections (q, k, v, o, gate, up: 6 under "none")
    full, _ = jax_matmul_counts(jax.make_jaxpr(jax.grad(_jax_remat("full", params, ids)[1]))(
        params))
    replayed = {"none": 6, "dots": 0, "mlp_dots": 4, "mlp_attn_dots": 2}[policy]
    assert sum(counts.values()) - sum(full.values()) == replayed
