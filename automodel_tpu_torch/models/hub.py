"""Where a pretrained model's files are (counterpart of ``automodel_tpu/models/hub.py``,
its local-directory branch). The port has no download: a hub repo id raises."""

from __future__ import annotations

import os
import re

__all__ = ["looks_like_repo_id", "resolve_pretrained_path"]

# org/name or bare name: hub id segments are [\w.-]+ with at most one slash; a path
# that exists on disk always wins over the hub reading
_REPO_ID_RE = re.compile(r"^[A-Za-z0-9][\w.-]*(/[\w.-]+)?$")


def looks_like_repo_id(path_or_id: str) -> bool:
    return bool(_REPO_ID_RE.match(path_or_id)) and not os.path.exists(path_or_id)


def resolve_pretrained_path(path_or_id: str) -> str:
    """A local HF model directory -> itself. A hub repo id raises NotImplementedError
    (the PyTorch package downloads nothing); anything else FileNotFoundError."""
    if os.path.isdir(path_or_id):
        return path_or_id
    if looks_like_repo_id(path_or_id):
        raise NotImplementedError(
            f"{path_or_id!r} reads as a Hugging Face hub repo id: hub download is not "
            "ported to the PyTorch package (ROADMAP.md); pass a local HF model directory")
    raise FileNotFoundError(f"{path_or_id!r} is not a local HF model directory")
