"""nanoGPT / fineweb ``.bin`` token shards (counterpart of
``automodel_tpu/data/llm/nanogpt_dataset.py``).

Shard format, as the public fineweb.py / nanoGPT tooling writes it:

    int32[256] header: [magic, version=1, num_tokens, itemsize or 0, ...]
    tokens: uint16 (legacy magic 20240520) or uint16 / uint32 (magic 278895051,
            header[3] = bytes a token)

The shards are memory-mapped and cut into samples of ``seq_len + 1`` tokens. The
dataset is map-style: the loader's seeded epoch order and its checkpointed cursor give
the iteration order and the mid-epoch resume.
"""

from __future__ import annotations

import glob
import logging

import numpy as np

logger = logging.getLogger(__name__)

__all__ = ["LEGACY_MAGIC", "MAGIC", "NanogptDataset", "peek_num_tokens", "write_shard"]

MAGIC = 278895051
LEGACY_MAGIC = 20240520
_HEADER_INTS = 256


def _header(path: str) -> np.ndarray:
    return np.fromfile(path, dtype=np.int32, count=_HEADER_INTS)


def peek_num_tokens(path: str) -> int:
    """The token count, from the header alone."""
    header = _header(path)
    if header[0] not in (MAGIC, LEGACY_MAGIC):
        raise ValueError(f"{path}: bad magic {int(header[0])}")
    return int(header[2])


def _shard_dtype(path: str) -> np.dtype:
    header = _header(path)
    if header[0] == LEGACY_MAGIC:
        return np.dtype(np.uint16)
    return np.dtype(np.uint32 if int(header[3]) == 4 else np.uint16)


def _read_tokens(path: str) -> np.ndarray:
    return np.memmap(path, dtype=_shard_dtype(path), mode="r", offset=_HEADER_INTS * 4,
                     shape=(peek_num_tokens(path),))


def write_shard(path: str, tokens: np.ndarray, dtype=np.uint16) -> None:
    """Write ``tokens`` as one shard in the modern format (magic 278895051)."""
    tokens = np.ascontiguousarray(tokens, dtype=dtype)
    header = np.zeros(_HEADER_INTS, np.int32)
    header[:4] = (MAGIC, 1, len(tokens), tokens.dtype.itemsize)
    with open(path, "wb") as f:
        f.write(header.tobytes())
        f.write(tokens.tobytes())


class NanogptDataset:
    """Sample i is tokens [i*S, i*S + S] of the shards concatenated (the extra token
    feeds the next-token shift); ``align_to_bos`` moves a sample's start forward to the
    next ``bos_token`` when the shifted window still fits."""

    def __init__(self, file_pattern: str | list[str], seq_len: int, align_to_bos: bool = False,
                 bos_token: int | None = None):
        paths = (sorted(glob.glob(file_pattern)) if isinstance(file_pattern, str)
                 else list(file_pattern))
        if not paths:
            raise FileNotFoundError(f"no shards match {file_pattern!r}")
        if align_to_bos and bos_token is None:
            raise ValueError("align_to_bos requires bos_token")
        self.paths = paths
        self.seq_len = seq_len
        self.align_to_bos = align_to_bos
        self.bos_token = bos_token
        self._shards = [_read_tokens(p) for p in paths]
        self._cum = np.cumsum([0] + [len(s) for s in self._shards])
        total = int(self._cum[-1])
        self._num_samples = (total - 1) // seq_len
        if self._num_samples <= 0:
            raise ValueError(f"corpus too small: {total} tokens < seq_len+1")
        logger.info("nanogpt dataset: %d shards, %d tokens, %d samples", len(paths), total,
                    self._num_samples)

    def __len__(self) -> int:
        return self._num_samples

    def _slice(self, start: int, length: int) -> np.ndarray:
        """Tokens [start, start + length), across shard boundaries."""
        out = np.empty(length, np.int64)
        filled = 0
        shard_i = int(np.searchsorted(self._cum, start, side="right")) - 1
        pos = start - int(self._cum[shard_i])
        while filled < length:
            shard = self._shards[shard_i]
            take = min(length - filled, len(shard) - pos)
            out[filled:filled + take] = shard[pos:pos + take]
            filled += take
            shard_i += 1
            pos = 0
        return out

    def __getitem__(self, idx: int) -> dict[str, np.ndarray]:
        start = (idx % self._num_samples) * self.seq_len
        tokens = self._slice(start, self.seq_len + 1)
        if self.align_to_bos:
            bos = np.nonzero(tokens == self.bos_token)[0]
            if len(bos) and bos[0] != 0:
                shift = int(bos[0])
                if start + shift + self.seq_len + 1 <= int(self._cum[-1]):
                    tokens = self._slice(start + shift, self.seq_len + 1)
        return {"input_ids": tokens}
