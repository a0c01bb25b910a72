"""Tokenizer from a local HF model directory, with BOS / EOS enforced (counterpart of
``automodel_tpu/models/auto_tokenizer.py``).

Delegates to ``transformers.AutoTokenizer`` (imported only here) and makes
``encode()`` emit BOS (and, when asked, EOS) where the model expects them: several HF
tokenizers ship with them switched off. Tokenizers of the mistral-common format and hub
repo ids are not ported and raise NotImplementedError.
"""

from __future__ import annotations

import glob
import os

from automodel_tpu_torch.models.hub import resolve_pretrained_path

__all__ = ["AutoTokenizer"]

# the files by which the JAX package routes a directory to mistral-common
_MISTRAL_FILES = ("tekken.json", "tokenizer.model.v*")


class AutoTokenizer:
    @classmethod
    def from_pretrained(cls, path: str, ensure_bos: bool = True, ensure_eos: bool = False,
                        **kwargs):
        path = resolve_pretrained_path(path)
        if any(glob.glob(os.path.join(path, pattern)) for pattern in _MISTRAL_FILES):
            raise NotImplementedError(f"{path!r} holds a mistral-common tokenizer, which is "
                                      "not ported to the PyTorch package yet")
        import transformers

        tok = transformers.AutoTokenizer.from_pretrained(path, **kwargs)
        return _EnforcingTokenizer(tok, ensure_bos=ensure_bos, ensure_eos=ensure_eos)


class _EnforcingTokenizer:
    def __init__(self, tok, ensure_bos: bool, ensure_eos: bool):
        self._tok = tok
        self.ensure_bos = ensure_bos and tok.bos_token_id is not None
        self.ensure_eos = ensure_eos and tok.eos_token_id is not None

    def __getattr__(self, name):
        return getattr(self._tok, name)

    def encode(self, text: str, **kwargs) -> list[int]:
        ids = list(self._tok.encode(text, **kwargs))
        if self.ensure_bos and (not ids or ids[0] != self._tok.bos_token_id):
            ids = [self._tok.bos_token_id] + ids
        if self.ensure_eos and (not ids or ids[-1] != self._tok.eos_token_id):
            ids = ids + [self._tok.eos_token_id]
        return ids

    def __call__(self, *args, **kwargs):
        return self._tok(*args, **kwargs)

    def __len__(self) -> int:
        return len(self._tok)
