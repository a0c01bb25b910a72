"""Checkpoint integrity manifests (the port's copy of
``automodel_tpu/checkpoint/manifest.py``, which it may not import).

Every finalized save writes a ``manifest.json`` into its step directory: the
inventory of the directory's files with their byte sizes and streaming CRC32
checksums. Restore verifies it before reading any tensor, so a truncated tensor
file, a half-written ``client.json`` or a missing shard is found on the host with a
named file instead of as an opaque deserialization error.

The manifest is written after the tensors are on disk and before the ``latest``
symlink commits, so its presence implies the step committed; its absence on an
otherwise complete directory means a checkpoint from before manifests, which the
caller may accept unverified.
"""

from __future__ import annotations

import json
import logging
import os
import time
import zlib
from concurrent.futures import ThreadPoolExecutor

logger = logging.getLogger(__name__)

__all__ = ["MANIFEST_NAME", "SAVING_MARKER", "build_manifest",
           "write_manifest", "verify_manifest", "has_manifest"]

MANIFEST_NAME = "manifest.json"
# Save-intent marker (see checkpointing.py): present in the step dir for the
# whole save, removed only after the manifest commits, so it is never inventoried
# (or every committed step would verify as "missing" it).
SAVING_MARKER = ".saving"
_CHUNK = 1 << 20  # 1 MiB read chunks: bounded memory on multi-GB array files
# A file is checksummed in segments of this many bytes on a pool of threads (zlib.crc32
# and the reads release the GIL; one core checksums ~1.4 GB/s, a third of a large save's
# time on the H100's machine), whose CRCs combine into the whole file's: the same value.
_SEGMENT = 1 << 26
_THREADS = min(8, os.cpu_count() or 1)


def _gf2_times(mat: list[int], vec: int) -> int:
    out, i = 0, 0
    while vec:
        if vec & 1:
            out ^= mat[i]
        vec >>= 1
        i += 1
    return out


def _gf2_square(mat: list[int]) -> list[int]:
    return [_gf2_times(mat, row) for row in mat]


def _zeros_operator(n: int) -> list[int]:
    """The GF(2) operator that appends ``n`` zero bytes to a CRC-32's message (zlib's
    crc32_combine): crc32(a + b) == _gf2_times(_zeros_operator(len(b)), crc32(a)) ^
    crc32(b)."""
    op = [1 << i for i in range(32)]  # identity
    zeros = [0xEDB88320] + [1 << i for i in range(31)]  # one zero bit
    for _ in range(3):  # one zero byte
        zeros = _gf2_square(zeros)
    while n:
        if n & 1:
            op = [_gf2_times(zeros, row) for row in op]
        n >>= 1
        if n:
            zeros = _gf2_square(zeros)
    return op


def _segment_crc32(path: str, start: int, length: int) -> int:
    crc = 0
    with open(path, "rb") as f:
        f.seek(start)
        while length:
            chunk = f.read(min(_CHUNK, length))
            if not chunk:
                raise OSError(f"{path!r} ended {length} bytes short of its size")
            crc = zlib.crc32(chunk, crc)
            length -= len(chunk)
    return crc


def _file_crc32(path: str) -> str:
    size = os.path.getsize(path)
    starts = range(0, size, _SEGMENT)
    if len(starts) <= 1 or _THREADS == 1:
        crc = _segment_crc32(path, 0, size)
    else:
        with ThreadPoolExecutor(_THREADS) as pool:
            crcs = list(pool.map(lambda s: _segment_crc32(path, s, min(_SEGMENT, size - s)),
                                 starts))
        whole = _zeros_operator(_SEGMENT)
        crc = crcs[0]
        for start, seg in zip(starts[1:], crcs[1:]):
            length = min(_SEGMENT, size - start)
            op = whole if length == _SEGMENT else _zeros_operator(length)
            crc = _gf2_times(op, crc) ^ seg
    return f"{crc & 0xFFFFFFFF:08x}"


def _walk_files(step_dir: str) -> list[str]:
    """Relative paths of every regular file under ``step_dir`` (sorted), minus
    the manifest itself and the ``.saving`` intent marker (the manifest is
    written while the marker is still present)."""
    out: list[str] = []
    for root, _, files in os.walk(step_dir):
        for name in files:
            if name in (MANIFEST_NAME, SAVING_MARKER):
                continue
            fp = os.path.join(root, name)
            if os.path.islink(fp):
                continue
            out.append(os.path.relpath(fp, step_dir))
    return sorted(out)


def build_manifest(step_dir: str, step: int | None = None,
                   extra: dict | None = None) -> dict:
    """Inventory + checksums for a finalized step directory."""
    files: dict[str, dict] = {}
    total = 0
    for rel in _walk_files(step_dir):
        fp = os.path.join(step_dir, rel)
        size = os.path.getsize(fp)
        files[rel] = {"bytes": size, "crc32": _file_crc32(fp)}
        total += size
    return {
        "version": 1,
        "step": step,
        "created_unix": round(time.time(), 3),
        "file_count": len(files),
        "total_bytes": total,
        "files": files,
        **(extra or {}),
    }


def write_manifest(step_dir: str, step: int | None = None,
                   extra: dict | None = None) -> str:
    """Build + atomically write the manifest; returns its path."""
    manifest = build_manifest(step_dir, step=step, extra=extra)
    path = os.path.join(step_dir, MANIFEST_NAME)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1)
    os.replace(tmp, path)
    return path


def has_manifest(step_dir: str) -> bool:
    return os.path.exists(os.path.join(step_dir, MANIFEST_NAME))


def verify_manifest(step_dir: str, check_checksums: bool = True) -> list[str]:
    """Verify a step dir against its manifest; returns a list of problems
    (empty = verified). A missing or unreadable manifest is itself a problem —
    callers that accept legacy pre-manifest checkpoints should gate on
    :func:`has_manifest` first."""
    path = os.path.join(step_dir, MANIFEST_NAME)
    if not os.path.exists(path):
        return [f"no {MANIFEST_NAME} in {step_dir!r}"]
    try:
        with open(path) as f:
            manifest = json.load(f)
        files = manifest["files"]
    except (ValueError, KeyError, OSError) as e:
        return [f"unreadable manifest {path!r}: {type(e).__name__}: {e}"]
    problems: list[str] = []
    for rel, meta in files.items():
        fp = os.path.join(step_dir, rel)
        if not os.path.exists(fp):
            problems.append(f"missing file {rel!r}")
            continue
        size = os.path.getsize(fp)
        if size != int(meta["bytes"]):
            problems.append(f"size mismatch {rel!r}: {size} != {meta['bytes']}")
            continue
        if check_checksums and _file_crc32(fp) != meta["crc32"]:
            problems.append(f"checksum mismatch {rel!r}")
    # files present but not inventoried are fine (eg. a later tool dropped a
    # README); files MISSING from the save are what kills a restore
    return problems
