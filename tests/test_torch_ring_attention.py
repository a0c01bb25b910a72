"""Context parallelism in the port against the JAX package.

- ``MeshContext`` validation, as tests/unit/test_mesh.py, and the one-card fold;
- the folded ``make_ring_attention`` against JAX's ``make_ring_attention`` on a cp=4 x
  dp_shard=2 mesh of the conftest's 8 CPU devices (JAX's flash ring in interpret mode):
  outputs atol 2e-5 and q/k/v gradients atol 5e-5 (the JAX ring tests' own limits);
- a tiny Llama under the cp=4 ring against JAX's Llama under the cp mesh and against the
  port at cp=1, forward and gradients;
- the benchmark recipe with ``distributed.cp 4`` and ring attention against its cp=1 run;
- the process-group ring: 4 gloo processes on the CPU, each with its shard, against the
  folded ring.

Inputs come from numpy seeds; f32 throughout. On the CPU the ring runs the chunk
kernels' plain version (ops/ring_chunk.py).
"""

import os
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automodel_tpu.models.common.backend import BackendConfig as JaxBackend
from automodel_tpu.models.llama.model import LlamaForCausalLM as JaxLlama
from automodel_tpu.ops.pallas.flash_attention import flash_attention as jax_flash
from automodel_tpu.parallel.mesh import MeshContext as JaxMesh
from automodel_tpu.parallel.mesh import default_sharding_rules
from automodel_tpu.parallel.ring_attention import make_ring_attention as jax_make_ring
from automodel_tpu_torch.config.cli_overrides import parse_args_and_load_config
from automodel_tpu_torch.models.common.backend import BackendConfig
from automodel_tpu_torch.models.llama.convert import params_from_jax
from automodel_tpu_torch.models.llama.model import LlamaForCausalLM
from automodel_tpu_torch.parallel import ring_attention as ra
from automodel_tpu_torch.parallel.mesh import MeshContext
from automodel_tpu_torch.recipes.llm import benchmark
from tests.torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL_OUT, ATOL_GRAD = 2e-5, 5e-5


@pytest.fixture(scope="module")
def cp_mesh():
    return JaxMesh(cp=4, dp_shard=2, world_size=8).build_mesh(jax.devices())


# ------------------------------------------------------------------ MeshContext


class TestMeshContext:
    def test_infer_dp_shard(self):
        ctx = MeshContext(tp=2, world_size=8)
        assert ctx.dp_shard == 4 and ctx.dp_size == 4 and not ctx.folded

    def test_explicit_sizes_validate(self):
        ctx = MeshContext(pp=2, dp_shard=2, tp=2, world_size=8)
        assert ctx.shape == {"pp": 2, "dp_replicate": 1, "dp_shard": 2, "ep": 1, "cp": 1,
                             "tp": 2}

    def test_bad_world_size_raises(self):
        with pytest.raises(ValueError):
            MeshContext(pp=3, world_size=8)
        with pytest.raises(ValueError):
            MeshContext(dp_shard=3, tp=2, world_size=8)

    def test_negative_axis_raises(self):
        with pytest.raises(ValueError):
            MeshContext(tp=0, world_size=8)

    def test_ep_carved_from_data(self):
        ctx = MeshContext(ep=4, tp=2, world_size=8)
        assert ctx.dp_shard == 1 and ctx.dp_size == 4

    def test_world_defaults_to_the_ranks(self):
        ctx = MeshContext()
        assert (ctx.world_size, ctx.dp_shard, ctx.folded) == (1, 1, False)
        with pytest.raises(ValueError):
            MeshContext(tp=2)  # one rank holds no second tp shard

    def test_one_rank_folds_cp(self):
        ctx = MeshContext(cp=8, dp_shard=-1)
        assert ctx.folded and ctx.world_size == 8 and ctx.dp_shard == 1
        assert ctx.active_axes == ("cp",)
        with pytest.raises(ValueError):
            MeshContext(cp=4, dp_shard=2)  # the fold holds cp shards only

    def test_explicit_world_does_not_fold(self):
        ctx = MeshContext(cp=4, world_size=8)
        assert not ctx.folded and ctx.dp_shard == 2


# ------------------------------------------------------------------ ring attention


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _positions(b, s):
    return np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()


def _jax_ring(cp_mesh, q, k, v, pos, seg=None, **kw):
    ring = jax_make_ring(cp_mesh, **kw)
    with jax.sharding.set_mesh(cp_mesh):
        out = ring(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
                   None if seg is None else jnp.asarray(seg))
    return np.asarray(out)


def _port_ring(cp, q, k, v, pos, seg=None, **kw):
    ring = ra.make_ring_attention(MeshContext(cp=cp), **kw)
    with torch.no_grad():
        return ring(torch.tensor(q), torch.tensor(k), torch.tensor(v), torch.tensor(pos),
                    None if seg is None else torch.tensor(seg)).numpy()


def _segments(b, s):
    seg = np.ones((b, s), np.int32)
    seg[:, s // 2:] = 2
    return seg


RING_CASES = {
    "causal": dict(shape=(2, 64, 4, 4, 16)),
    "gqa_segments": dict(shape=(2, 64, 8, 2, 16), segments=True),
    "sliding_window": dict(shape=(1, 64, 2, 2, 16), kw=dict(sliding_window=16)),
    "mla_dv": dict(shape=(2, 64, 4, 4, 24), dv=16, kw=dict(softmax_scale=24**-0.5)),
}


@pytest.mark.parametrize("name", list(RING_CASES))
def test_folded_ring_matches_jax_ring(cp_mesh, name):
    case = RING_CASES[name]
    b, s, n, kh, d = case["shape"]
    dv = case.get("dv", d)
    q, k, v = _rand(1, b, s, n, d), _rand(2, b, s, kh, d), _rand(3, b, s, kh, dv)
    pos = _positions(b, s)
    seg = _segments(b, s) if case.get("segments") else None
    want = _jax_ring(cp_mesh, q, k, v, pos, seg, **case.get("kw", {}))
    got = _port_ring(4, q, k, v, pos, seg, **case.get("kw", {}))
    np.testing.assert_allclose(got, want, atol=ATOL_OUT, rtol=0)


def test_interleaved_positions_load_balance(cp_mesh):
    """Global positions travel with the tokens: the round-robin layout gives the same
    math as JAX's ring on the same layout."""
    b, s, n, d = 1, 64, 2, 8
    q, k, v = _rand(12, b, s, n, d), _rand(13, b, s, n, d), _rand(14, b, s, n, d)
    order = np.arange(s).reshape(4, -1).T.reshape(-1)
    pos = np.asarray(order, np.int32)[None].repeat(b, 0)
    want = _jax_ring(cp_mesh, q[:, order], k[:, order], v[:, order], pos)
    got = _port_ring(4, q[:, order], k[:, order], v[:, order], pos)
    np.testing.assert_allclose(got, want, atol=ATOL_OUT, rtol=0)


def _port_grads(fn, q, k, v, do):
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = fn(qt, kt, vt)
    return [g.numpy() for g in torch.autograd.grad(out, (qt, kt, vt), torch.tensor(do))]


def test_grads_match_jax_ring(cp_mesh):
    b, s, n, kh, d = 1, 64, 4, 2, 8
    q, k, v = _rand(9, b, s, n, d), _rand(10, b, s, kh, d), _rand(11, b, s, kh, d)
    do = _rand(15, b, s, n, d)
    pos, seg = _positions(b, s), _segments(b, s)
    ring = jax_make_ring(cp_mesh)

    def loss(q_, k_, v_):
        return jnp.sum(ring(q_, k_, v_, jnp.asarray(pos), jnp.asarray(seg)) * jnp.asarray(do))

    with jax.sharding.set_mesh(cp_mesh):
        want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(jnp.asarray(q), jnp.asarray(k),
                                                          jnp.asarray(v))
    port = ra.make_ring_attention(MeshContext(cp=4))
    got = _port_grads(lambda a, b_, c: port(a, b_, c, torch.tensor(pos), torch.tensor(seg)),
                      q, k, v, do)
    for g, w, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g, np.asarray(w), atol=ATOL_GRAD, rtol=0, err_msg=f"d{name}")


def test_flash_vs_dense_grads():
    """The flash ring's explicit backward against autograd through the dense ring."""
    b, s, n, kh, d = 1, 256, 4, 2, 16
    q, k, v = _rand(43, b, s, n, d), _rand(44, b, s, kh, d), _rand(45, b, s, kh, d)
    do = _rand(46, b, s, n, d)
    pos = torch.tensor(_positions(b, s))
    mesh = MeshContext(cp=4)
    grads = {impl: _port_grads(
        lambda a, b_, c, impl=impl: ra.make_ring_attention(mesh, impl=impl)(a, b_, c, pos),
        q, k, v, do) for impl in ("flash", "dense")}
    for f, dn, name in zip(grads["flash"], grads["dense"], "qkv"):
        np.testing.assert_allclose(f, dn, atol=ATOL_GRAD, rtol=0, err_msg=f"d{name}")


def test_cp1_degenerate_matches_flash_kernel():
    b, s, n, d = 2, 64, 4, 16
    q, k, v = _rand(40, b, s, n, d), _rand(41, b, s, n, d), _rand(42, b, s, n, d)
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                                interpret=True, block_q=32, block_k=32))
    got = _port_ring(1, q, k, v, _positions(b, s))
    np.testing.assert_allclose(got, want, atol=ATOL_OUT, rtol=0)


def test_unknown_impl_and_untileable_sequence_raise():
    ring = ra.make_ring_attention(MeshContext(cp=4))
    x = torch.zeros(1, 10, 2, 8)
    with pytest.raises(ValueError, match="divide by cp"):
        ring(x, x, x, torch.zeros(1, 10, dtype=torch.int32))
    with pytest.raises(ValueError, match="unknown ring impl"):
        ra.make_ring_attention(MeshContext(cp=4), impl="bogus")(
            *(torch.zeros(1, 8, 2, 8),) * 3, torch.zeros(1, 8, dtype=torch.int32))
    with pytest.raises(NotImplementedError):
        ra.make_ring_attention(MeshContext(cp=4, world_size=4))


def test_chunk_functions_get_contiguous_rows_at_batch_one(monkeypatch):
    """At a local batch of 1 (one shard per process, or cp 1) the (B, S, H, D) -> row
    reshape is a strided view; the kernels refuse non-contiguous rows on the card, so
    the ring must hand them contiguous tensors (the CPU plain version would not notice)."""
    seen = []

    def check(fn):
        def wrapped(q, k, v, *args, **kw):
            seen.append(all(t.is_contiguous() for t in (q, k, v)))
            return fn(q, k, v, *args, **kw)
        return wrapped

    from automodel_tpu_torch.ops import ring_chunk as rc

    # the CPU route of the chunk wrappers: what they get is what a kernel would get
    for name in ("chunk_attention_fwd_reference", "chunk_attention_bwd_reference"):
        monkeypatch.setattr(rc, name, check(getattr(rc, name)))
    b, s, n, kh, d = 1, 16, 4, 2, 8
    q, k, v = _rand(53, b, s, n, d), _rand(54, b, s, kh, d), _rand(55, b, s, kh, d)
    pos = torch.tensor(_positions(b, s))
    _port_grads(lambda a, b_, c: ra.ring_attention_local(a, b_, c, pos, pos,
                                                         rotation=ra.FoldedRotation(1)),
                q, k, v, _rand(56, b, s, n, d))
    assert seen and all(seen)


def test_ragged_local_length_takes_the_flash_ring():
    """Local lengths that no power-of-two block tiles (JAX sends them to dense) take the
    flash ring in the port, and agree with the dense oracle."""
    b, s, n, d = 1, 60, 2, 8  # cp 3 -> 20 a shard
    q, k, v = _rand(50, b, s, n, d), _rand(51, b, s, n, d), _rand(52, b, s, n, d)
    pos = _positions(b, s)
    flash = _port_ring(3, q, k, v, pos, impl="flash")
    dense = _port_ring(3, q, k, v, pos, impl="dense")
    np.testing.assert_allclose(flash, dense, atol=ATOL_OUT, rtol=0)


# ------------------------------------------------------------------ Llama under cp=4

HF = dict(architectures=["LlamaForCausalLM"], vocab_size=128, hidden_size=64,
          intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
          num_key_value_heads=2, max_position_embeddings=256, rope_theta=10000.0)


def _batch(b=2, s=64):
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 128, (b, s)).astype(np.int32)
    seg = np.ones((b, s), np.int32)
    seg[0, s // 2:] = 2
    pos = np.concatenate([np.arange(s // 2), np.arange(s // 2)])[None].repeat(b, 0)
    pos[1] = np.arange(s)
    return ids, pos.astype(np.int32), seg


def _port_llama_logits_grads(params, ids, pos, seg, w, mesh, context_parallel):
    tm = LlamaForCausalLM.from_config(HF, BackendConfig(dtype="float32", remat_policy="full",
                                                        context_parallel=context_parallel),
                                      device="cpu")
    tm.load_params(params_from_jax(params, tm.config))
    names, leaves = zip(*tm.param_dict().items())
    logits = tm(torch.tensor(ids), positions=torch.tensor(pos), segment_ids=torch.tensor(seg),
                mesh=mesh)
    grads = torch.autograd.grad((logits * torch.tensor(w)).sum(), leaves)
    return logits.detach().numpy(), dict(zip(names, (g.numpy() for g in grads)))


def test_llama_cp4_ring_matches_jax_and_cp1(cp_mesh):
    jm = JaxLlama.from_config(HF, JaxBackend(dtype="float32", remat_policy="full",
                                             context_parallel="ring"))
    params = jax.device_get(jm.init(jax.random.key(0)))
    ids, pos, seg = _batch()
    w = _rand(7, 2, 64, 128)
    rules = default_sharding_rules().with_mesh(cp_mesh)

    def loss(p):
        logits = jm(p, jnp.asarray(ids), positions=jnp.asarray(pos),
                    segment_ids=jnp.asarray(seg), rules=rules)
        return jnp.sum(logits * jnp.asarray(w)), logits

    with jax.sharding.set_mesh(cp_mesh):
        (_, want_logits), want_grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    want_grads = params_from_jax(jax.device_get(want_grads),
                                 LlamaForCausalLM.config_class.from_hf(HF))

    got_logits, got_grads = _port_llama_logits_grads(params, ids, pos, seg, w,
                                                     MeshContext(cp=4), "ring")
    np.testing.assert_allclose(got_logits, np.asarray(want_logits), rtol=1e-4, atol=1e-4)
    for name, g in got_grads.items():
        np.testing.assert_allclose(g, want_grads[name].numpy(), rtol=1e-4, atol=1e-4,
                                   err_msg=name)

    cp1_logits, cp1_grads = _port_llama_logits_grads(params, ids, pos, seg, w, MeshContext(),
                                                     "allgather")
    # the ring merges the softmax chunk by chunk: f32 sums in another order than the one
    # pass at cp=1; gradients of magnitude ~20 differ in the sixth digit
    np.testing.assert_allclose(got_logits, cp1_logits, rtol=1e-5, atol=1e-5)
    for name, g in got_grads.items():
        np.testing.assert_allclose(g, cp1_grads[name], rtol=1e-4, atol=1e-4, err_msg=name)


def test_qwen3_moe_cp4_ring_matches_cp1():
    """The MoE decoder calls the same attention block, so Qwen3-MoE takes the ring too."""
    from automodel_tpu_torch.models.qwen3_moe.model import Qwen3MoeForCausalLM

    hf = dict(architectures=["Qwen3MoeForCausalLM"], vocab_size=128, hidden_size=64,
              intermediate_size=96, moe_intermediate_size=32, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=2, head_dim=16, num_experts=8,
              num_experts_per_tok=2, norm_topk_prob=True, max_position_embeddings=128)
    ids, pos, seg = _batch()
    out = {}
    for name, mode, mesh in (("ring", "ring", MeshContext(cp=4)),
                             ("cp1", "allgather", None)):
        model = Qwen3MoeForCausalLM.from_config(
            hf, BackendConfig(dtype="float32", remat_policy="full", context_parallel=mode),
            device="cpu", generator=torch.Generator().manual_seed(0))
        with torch.no_grad():
            logits, _ = model(torch.tensor(ids), positions=torch.tensor(pos),
                              segment_ids=torch.tensor(seg), mesh=mesh)
        out[name] = logits.numpy()
    np.testing.assert_allclose(out["ring"], out["cp1"], rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------ the recipe

YAML = """
seed: 7
device: cpu
model:
  params_dtype: float32
  config:
    architectures: [LlamaForCausalLM]
    vocab_size: 128
    hidden_size: 64
    intermediate_size: 128
    num_hidden_layers: 2
    num_attention_heads: 4
    num_key_value_heads: 2
distributed:
  dp_shard: -1
backend:
  dtype: float32
  attention: flash
  remat_policy: dots
dataset:
  _target_: automodel_tpu.data.llm.mock.MockSFTDataset
  vocab_size: 128
  seq_len: 32
  num_samples: 64
  seed: 0
benchmark:
  warmup_steps: 1
  timed_steps: 2
micro_batch_size: 4
seq_len: 32
step_scheduler:
  grad_acc_steps: 2
  max_steps: 3
loss:
  name: masked_ce
optimizer:
  lr: 1.0e-3
  max_grad_norm: 1.0
"""


def test_benchmark_recipe_cp4_ring_matches_cp1(tmp_path):
    path = tmp_path / "cp.yaml"
    path.write_text(textwrap.dedent(YAML))
    runs = {}
    for name, extra in (("cp1", []), ("cp4", ["--distributed.cp", "4",
                                              "--backend.context_parallel", "ring"])):
        cfg = parse_args_and_load_config(["-c", str(path), "--output_dir",
                                          str(tmp_path / name), *extra])
        recipe = benchmark.BenchmarkingRecipeForNextTokenPrediction(cfg)
        recipe.setup()
        assert recipe.mesh.cp == (4 if name == "cp4" else 1)
        assert recipe.mesh.folded == (name == "cp4")
        runs[name] = recipe.run_benchmark()["losses"]
    assert len(runs["cp4"]) == 3
    np.testing.assert_allclose(runs["cp4"], runs["cp1"], atol=1e-5, rtol=0)


def test_recipe_checks_pack_size_against_cp(tmp_path):
    path = tmp_path / "cp.yaml"
    path.write_text(textwrap.dedent(YAML))
    cfg = parse_args_and_load_config(["-c", str(path), "--output_dir", str(tmp_path / "r"),
                                      "--distributed.cp", "3",
                                      "--packed_sequence.packed_sequence_size", "32"])
    with pytest.raises(ValueError, match="divide by cp"):
        benchmark.BenchmarkingRecipeForNextTokenPrediction(cfg).setup()


# ------------------------------------------------------------------ process-group ring

_RANK_SCRIPT = r"""
import sys
import numpy as np
import torch
sys.path.insert(0, {root!r})
from automodel_tpu_torch.parallel.init import initialize_distributed
from automodel_tpu_torch.parallel.ring_attention import ProcessGroupRotation, ring_attention_local

info = initialize_distributed(device="cpu", timeout_s=60)
data = np.load({inputs!r})
s_loc = data["q"].shape[1] // info.world_size
sl = slice(info.rank * s_loc, (info.rank + 1) * s_loc)
q, k, v = (torch.tensor(data[n][:, sl], requires_grad=True) for n in ("q", "k", "v"))
pos, seg = torch.tensor(data["pos"][:, sl]), torch.tensor(data["seg"][:, sl])
out = ring_attention_local(q, k, v, pos, pos, seg, seg, rotation=ProcessGroupRotation())
grads = torch.autograd.grad(out, (q, k, v), torch.tensor(data["do"][:, sl]))
np.savez({outputs!r} % info.rank, out=out.detach().numpy(),
         **{{n: g.numpy() for n, g in zip(("dq", "dk", "dv"), grads)}})
torch.distributed.destroy_process_group()
"""


def _free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def test_process_group_ring_matches_folded(tmp_path):
    """4 gloo processes, one shard each, rotate with batch_isend_irecv; their outputs and
    gradients are the folded ring's slices. A hung peer fails the test: the group has a
    60 s timeout, the join 120 s, and an expired process is killed."""
    cp, b, s, n, kh, d = 4, 1, 64, 4, 2, 8
    data = {"q": _rand(60, b, s, n, d), "k": _rand(61, b, s, kh, d), "v": _rand(62, b, s, kh, d),
            "do": _rand(63, b, s, n, d), "pos": _positions(b, s), "seg": _segments(b, s)}
    inputs = str(tmp_path / "inputs.npz")
    np.savez(inputs, **data)
    outputs = str(tmp_path / "rank%d.npz")
    script = _RANK_SCRIPT.format(root=ROOT, inputs=inputs, outputs=outputs)
    port = _free_port()
    procs = []
    for rank in range(cp):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(cp), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen([sys.executable, "-c", script], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)

    pos, seg = torch.tensor(data["pos"]), torch.tensor(data["seg"])
    ring = ra.make_ring_attention(MeshContext(cp=cp))
    qt, kt, vt = (torch.tensor(data[x], requires_grad=True) for x in ("q", "k", "v"))
    out = ring(qt, kt, vt, pos, seg)
    grads = torch.autograd.grad(out, (qt, kt, vt), torch.tensor(data["do"]))
    want = {"out": out.detach().numpy(), **{x: g.numpy() for x, g in zip(("dq", "dk", "dv"),
                                                                         grads)}}
    s_loc = s // cp
    for rank in range(cp):
        got = np.load(outputs % rank)
        sl = slice(rank * s_loc, (rank + 1) * s_loc)
        for name in ("out", "dq", "dk", "dv"):
            np.testing.assert_allclose(got[name], want[name][:, sl], atol=1e-6, rtol=0,
                                       err_msg=f"rank {rank} {name}")
