"""HF safetensors read and write without the ``safetensors`` package (counterpart of
``automodel_tpu/checkpoint/safetensors_io.py``).

The format: 8 bytes of little-endian header length, a JSON header mapping each
tensor's name to its ``dtype``, ``shape`` and ``data_offsets`` (begin and end in the
data section, which follows the header) with an optional ``__metadata__`` map of
strings, then the raw little-endian bytes of every tensor.

Reading accepts a directory (one ``model.safetensors``, or shards listed by
``model.safetensors.index.json``) or one file, and returns a lazy mapping: each
tensor is read from disk when it is asked for, so host memory is bounded by the
largest tensor. Writing shards greedily at 5 GiB with an index, as HF does; values
may be tensors on any device or :class:`LazyHFTensor`-like objects with ``nbytes``
and ``materialize()``, each brought to the host only while its shard is written.
"""

from __future__ import annotations

import json
import os
import struct
from collections.abc import Mapping
from typing import Any, Iterator

import torch

from automodel_tpu_torch.utils.retry import with_retry

__all__ = ["LazySafetensors", "load_safetensors", "save_safetensors"]

INDEX_NAME = "model.safetensors.index.json"
DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
          "I64": torch.int64, "I32": torch.int32, "BOOL": torch.bool}
_CODES = {v: k for k, v in DTYPES.items()}
_MAX_HEADER = 100 * 1024 * 1024  # the safetensors package's own limit


def read_header(path: str) -> tuple[dict, int]:
    """(header without ``__metadata__``, byte offset of the data section) of one file;
    ValueError for a file that is not safetensors or is cut short."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) < 8:
            raise ValueError(f"{path!r}: not a safetensors file ({size} bytes)")
        (n,) = struct.unpack("<Q", head)
        if n > min(_MAX_HEADER, size - 8):
            raise ValueError(f"{path!r}: header length {n} exceeds the file")
        try:
            header = json.loads(f.read(n))
        except ValueError as e:
            raise ValueError(f"{path!r}: unreadable safetensors header ({e})") from e
    header.pop("__metadata__", None)
    start = 8 + n
    for key, info in header.items():
        if info["dtype"] not in DTYPES:
            raise ValueError(f"{path!r}: tensor {key!r} has dtype {info['dtype']}, "
                             f"not one of {sorted(DTYPES)}")
        begin, end = info["data_offsets"]
        want = DTYPES[info["dtype"]].itemsize * _numel(info["shape"])
        if end - begin != want or start + end > size:
            raise ValueError(f"{path!r}: tensor {key!r} offsets {begin}..{end} do not hold "
                             f"{want} bytes inside the file ({size} bytes)")
    return header, start


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _read_tensor(path: str, info: dict, start: int) -> torch.Tensor:
    begin, end = info["data_offsets"]
    dtype = DTYPES[info["dtype"]]
    if end == begin:
        return torch.empty(info["shape"], dtype=dtype)
    buf = bytearray(end - begin)
    with open(path, "rb") as f:
        f.seek(start + begin)
        if f.readinto(buf) != len(buf):
            raise ValueError(f"{path!r}: file ends inside a tensor")
    # numpy has no bf16: the bytes become a uint8 tensor viewed as the stored dtype
    return torch.frombuffer(buf, dtype=torch.uint8).view(dtype).reshape(info["shape"])


class LazySafetensors(Mapping):
    """Dict-like view over safetensors files; reads a tensor (a CPU tensor) on access."""

    def __init__(self, files: dict[str, str]):
        self._files = files  # tensor name -> file path
        self._headers: dict[str, tuple[dict, int]] = {}

    def _header(self, path: str) -> tuple[dict, int]:
        if path not in self._headers:
            self._headers[path] = read_header(path)
        return self._headers[path]

    def __getitem__(self, key: str) -> torch.Tensor:
        path = self._files[key]

        def read():
            header, start = self._header(path)
            return _read_tensor(path, header[key], start)

        # network filesystems surface transient EIOs; a truncated file raises a
        # ValueError, which is not transient and fails at once
        return with_retry(read, description=f"safetensors read {key!r}")

    def __contains__(self, key) -> bool:  # from the headers: no tensor is read
        return key in self._files

    def __iter__(self) -> Iterator[str]:
        return iter(self._files)

    def __len__(self) -> int:
        return len(self._files)


def load_safetensors(path: str) -> LazySafetensors:
    """A safetensors file or HF model directory -> lazy name -> tensor mapping."""
    if os.path.isfile(path):
        files = [path]
    else:
        index = os.path.join(path, INDEX_NAME)
        if os.path.exists(index):
            try:
                with open(index) as f:
                    weight_map = json.load(f)["weight_map"]
            except (ValueError, KeyError) as e:
                raise ValueError(f"corrupt safetensors index at {index!r} "
                                 f"({type(e).__name__}: {e})") from e
            key_to_file = {k: os.path.join(path, v) for k, v in weight_map.items()}
            missing = sorted({v for v in key_to_file.values() if not os.path.exists(v)})
            if missing:
                raise FileNotFoundError(
                    f"safetensors index {index!r} references missing shard file(s): "
                    f"{[os.path.basename(m) for m in missing[:3]]}")
            return LazySafetensors(key_to_file)
        files = sorted(os.path.join(path, f) for f in os.listdir(path)
                       if f.endswith(".safetensors"))
        if not files:
            raise FileNotFoundError(f"no .safetensors files under {path!r}")
    key_to_file: dict[str, str] = {}
    for fp in files:
        for k in read_header(fp)[0]:
            key_to_file[k] = fp
    return LazySafetensors(key_to_file)


def _host(value: Any) -> torch.Tensor:
    t = value.materialize() if hasattr(value, "materialize") else value
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"cannot write {type(t).__name__} as a safetensors tensor")
    if t.dtype not in _CODES:
        raise ValueError(f"dtype {t.dtype} has no safetensors code here ({sorted(DTYPES)})")
    return t.detach().to("cpu").contiguous()


def _write_file(path: str, tensors: dict[str, torch.Tensor], metadata: dict[str, str]) -> None:
    header: dict[str, Any] = {"__metadata__": metadata}
    offset = 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _CODES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)  # the data section starts 8-byte aligned
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for t in tensors.values():
            if t.numel():
                f.write(t.view(-1).view(torch.uint8).numpy().data)
    os.replace(tmp, path)


def save_safetensors(tensors: Mapping[str, Any], out_dir: str,
                     max_shard_bytes: int = 5 * 1024**3,
                     metadata: dict[str, str] | None = None) -> list[str]:
    """Write ``tensors`` as HF-sharded safetensors (with the index when sharded) and
    return the files written. Shards are planned from each value's ``nbytes``, so
    nothing is materialized before its shard is written, and each shard's tensors
    are dropped before the next shard's are brought to the host."""
    os.makedirs(out_dir, exist_ok=True)
    shards: list[list[tuple[str, Any]]] = [[]]
    size = 0
    for k, v in tensors.items():
        nbytes = int(v.nbytes)
        if size + nbytes > max_shard_bytes and shards[-1]:
            shards.append([])
            size = 0
        shards[-1].append((k, v))
        size += nbytes
    meta = {"format": "pt", **(metadata or {})}
    if len(shards) == 1:
        fp = os.path.join(out_dir, "model.safetensors")
        _write_file(fp, {k: _host(v) for k, v in shards[0]}, meta)
        return [fp]
    weight_map: dict[str, str] = {}
    total = 0
    written = []
    for idx, shard in enumerate(shards, start=1):
        name = f"model-{idx:05d}-of-{len(shards):05d}.safetensors"
        fp = os.path.join(out_dir, name)
        buf = {k: _host(v) for k, v in shard}
        _write_file(fp, buf, meta)
        for k, t in buf.items():
            weight_map[k] = name
            total += t.numel() * t.element_size()
        written.append(fp)
        del buf
    with open(os.path.join(out_dir, INDEX_NAME), "w") as f:
        json.dump({"metadata": {"total_size": total}, "weight_map": weight_map}, f, indent=2)
    return written
