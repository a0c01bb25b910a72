"""The port's safetensors reader and writer (no safetensors package) against the
safetensors package in both directions, and against the JAX package's writer, sharded
and unsharded: every tensor bitwise equal, dtype for dtype (F32, F16, BF16, I64, I32,
BOOL); and the errors a damaged checkpoint raises."""

import json
import os
import struct

import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors import safe_open
from safetensors.torch import load_file, save_file

from automodel_tpu.checkpoint.safetensors_io import load_safetensors as jax_load
from automodel_tpu.checkpoint.safetensors_io import save_safetensors as jax_save
from automodel_tpu_torch.checkpoint.safetensors_io import (INDEX_NAME, load_safetensors,
                                                           save_safetensors)
from automodel_tpu_torch.models.common.state_dict import LazyHFTensor
from tests.torch_threads import one_intra_op_thread  # noqa: F401 (autouse)


def _tensors(seed=0) -> dict[str, torch.Tensor]:
    rng = np.random.RandomState(seed)
    return {
        "f32": torch.from_numpy(rng.randn(3, 5).astype(np.float32)),
        "f16": torch.from_numpy(rng.randn(4, 2).astype(np.float16)),
        "bf16": torch.from_numpy(rng.randn(7, 3).astype(np.float32)).to(torch.bfloat16),
        "i64": torch.from_numpy(rng.randint(-2**40, 2**40, (6,)).astype(np.int64)),
        "i32": torch.from_numpy(rng.randint(-9, 9, (2, 2, 2)).astype(np.int32)),
        "bool": torch.from_numpy(rng.rand(5) > 0.5),
        "scalar": torch.tensor(3.5),
        "empty": torch.zeros(0, 4),
    }


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def test_port_writes_what_the_package_reads(tmp_path):
    want = _tensors()
    [path] = save_safetensors(want, str(tmp_path))
    got = load_file(path)
    assert set(got) == set(want) and all(_same(got[k], want[k]) for k in want)
    with safe_open(path, framework="pt") as f:
        assert f.metadata() == {"format": "pt"}


def test_port_reads_what_the_package_writes(tmp_path):
    want = _tensors(1)
    save_file(want, str(tmp_path / "model.safetensors"), metadata={"format": "pt"})
    got = load_safetensors(str(tmp_path))
    assert set(got) == set(want) and all(_same(got[k], want[k]) for k in want)


def test_sharded_write_with_index_and_lazy_values(tmp_path):
    """5 GiB shards at a small budget: an index, every shard readable by the package and
    by the JAX reader; lazy values are materialized only when their shard is written."""
    want = _tensors(2)
    calls = []

    def lazy(name):
        def thunk():
            calls.append(name)
            return want[name]
        return LazyHFTensor(thunk, want[name].nbytes)

    files = save_safetensors({k: lazy(k) for k in want}, str(tmp_path), max_shard_bytes=48)
    assert len(files) > 2 and calls == list(want)
    with open(tmp_path / INDEX_NAME) as f:
        index = json.load(f)
    assert set(index["weight_map"]) == set(want)
    assert index["metadata"]["total_size"] == sum(t.nbytes for t in want.values())
    from_pkg = {}
    for fp in files:
        from_pkg |= load_file(fp)
    assert all(_same(from_pkg[k], want[k]) for k in want)
    got = load_safetensors(str(tmp_path))
    assert all(_same(got[k], want[k]) for k in want)
    jax_side = jax_load(str(tmp_path))
    np.testing.assert_array_equal(jax_side["f32"], want["f32"].numpy())
    assert jax_side["bf16"].dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(jax_side["bf16"].view(np.uint16),
                                  want["bf16"].view(torch.uint16).numpy())


@pytest.mark.parametrize("shard_bytes", [5 * 1024**3, 40], ids=["unsharded", "sharded"])
def test_port_reads_the_jax_writer(tmp_path, shard_bytes):
    rng = np.random.RandomState(3)
    want = {"w": rng.randn(4, 6).astype(np.float32),
            "b": rng.randn(9).astype(ml_dtypes.bfloat16),
            "h": rng.randn(2, 3).astype(np.float16),
            "ids": rng.randint(0, 100, (5,)).astype(np.int64)}
    jax_save(want, str(tmp_path), max_shard_bytes=shard_bytes)
    assert os.path.exists(tmp_path / INDEX_NAME) == (shard_bytes == 40)
    got = load_safetensors(str(tmp_path))
    assert set(got) == set(want)
    for k, v in want.items():
        if v.dtype == ml_dtypes.bfloat16:
            assert got[k].dtype == torch.bfloat16
            np.testing.assert_array_equal(got[k].view(torch.uint16).numpy(), v.view(np.uint16))
        else:
            np.testing.assert_array_equal(got[k].numpy(), v)
            assert got[k].numpy().dtype == v.dtype


def test_damaged_files_raise(tmp_path):
    [path] = save_safetensors({"a": torch.ones(64)}, str(tmp_path / "ok"))
    raw = open(path, "rb").read()
    cut = tmp_path / "cut.safetensors"
    cut.write_bytes(raw[:-8])
    with pytest.raises(ValueError, match="do not hold|inside the file"):
        load_safetensors(str(cut))["a"]
    bad = tmp_path / "bad.safetensors"
    bad.write_bytes(struct.pack("<Q", 10**6) + b"{}")
    with pytest.raises(ValueError, match="exceeds the file"):
        load_safetensors(str(bad))
    f64 = tmp_path / "f64"
    f64.mkdir()
    save_file({"x": torch.zeros(2, dtype=torch.float64)}, str(f64 / "model.safetensors"))
    with pytest.raises(ValueError, match="F64"):
        load_safetensors(str(f64))
    sharded = tmp_path / "sharded"
    save_safetensors({"a": torch.ones(8), "b": torch.ones(8)}, str(sharded), max_shard_bytes=32)
    os.remove(sharded / "model-00002-of-00002.safetensors")
    with pytest.raises(FileNotFoundError, match="missing shard"):
        load_safetensors(str(sharded))
    (sharded / INDEX_NAME).write_text("{not json")
    with pytest.raises(ValueError, match="corrupt safetensors index"):
        load_safetensors(str(sharded))
