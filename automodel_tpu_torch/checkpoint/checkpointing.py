"""Checkpoint save and restore on one process (counterpart of
``automodel_tpu/checkpoint/checkpointing.py``).

Layout of a save, as the JAX package lays it out:

    <root>/step_{N}/model/          the parameters (under PEFT the adapter alone),
                                    torch.distributed.checkpoint
    <root>/step_{N}/optim/          the optimizer state, torch.distributed.checkpoint
    <root>/step_{N}/client.json     step scheduler and dataloader state_dicts
    <root>/step_{N}/signature.json  name -> "shape/dtype" of every parameter, and the
                                    saving topology under ``__topology__``
    <root>/step_{N}/hf/             consolidated HF safetensors and config.json (optional)
    <root>/step_{N}/manifest.json   the integrity manifest (checkpoint/manifest.py)
    <root>/latest -> step_{N}

``model/`` and ``optim/`` are the port's own format (the JAX package's are Orbax trees,
which cannot be read without JAX); ``hf/`` is the format both packages read and write.
A restore loads in place into the tensors it is given, which may live on the card.

The save is ordered so that a step directory is restorable exactly when it committed:
the ``.saving`` marker is written before the first byte and removed only after the
manifest commits, then ``latest`` moves. A restore verifies the manifest first and
walks back past torn or corrupt steps. Asynchronous saves and an elastic resume (a
checkpoint saved on another mesh) raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import shutil
import warnings
from typing import Any, Mapping

import torch

from automodel_tpu_torch.checkpoint.manifest import (SAVING_MARKER, has_manifest,
                                                     verify_manifest, write_manifest)
from automodel_tpu_torch.checkpoint.reshard import (TOPOLOGY_KEY, ModelSignatureMismatch,
                                                    describe_delta, mesh_delta, strip_topology)
from automodel_tpu_torch.utils.retry import RetryConfig, with_retry

logger = logging.getLogger(__name__)

__all__ = ["CheckpointingConfig", "Checkpointer", "ModelSignatureMismatch", "flatten_state"]

_DCP_METADATA = ".metadata"  # written last by torch.distributed.checkpoint's save


@dataclasses.dataclass
class CheckpointingConfig:
    enabled: bool = True
    checkpoint_dir: str = "checkpoints"
    save_consolidated: bool = False  # also write HF safetensors per save
    keep_last_k: int | None = None  # prune old step dirs
    async_save: bool = False  # not ported: True raises
    write_manifest: bool = True  # integrity manifest per save
    verify_on_load: bool = True  # manifest-verify a step before restoring it
    retry: dict | None = None  # transient-I/O retry tuning (utils/retry.py)


def flatten_state(tree: Any, prefix: str = "") -> dict[str, torch.Tensor]:
    """Nested dicts and lists of tensors -> one flat dict with dotted keys (an optimizer
    state ``[{"count": t}, {"mu": {...}}]`` gives ``0.count``, ``1.mu.layers.wq``). The
    values are the tree's own tensors, so loading into them restores the tree."""
    if isinstance(tree, torch.Tensor):
        return {prefix[:-1]: tree}
    if isinstance(tree, Mapping):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        raise TypeError(f"cannot checkpoint {type(tree).__name__} at {prefix[:-1]!r}")
    flat: dict[str, torch.Tensor] = {}
    for key, value in items:
        flat |= flatten_state(value, f"{prefix}{key}.")
    return flat


class Checkpointer:
    """Save and restore the parameters, the optimizer state and the client (host) states."""

    def __init__(self, config: CheckpointingConfig, state_dict_adapter=None,
                 hf_config: dict | None = None):
        if config.async_save:
            raise NotImplementedError("checkpoint.async_save is not ported to the PyTorch "
                                      "package yet (ROADMAP.md); set it to false")
        self.config = config
        self.config.checkpoint_dir = os.path.abspath(config.checkpoint_dir)
        self.state_dict_adapter = state_dict_adapter  # for the consolidated HF export
        self.hf_config = hf_config
        self._pending: int | None = None
        self._retry = RetryConfig.from_dict(config.retry)
        # the saving topology (reshard.build_topology), recorded by save() and compared
        # by load()
        self.topology: dict | None = None

    # -- paths --------------------------------------------------------------
    def step_dir(self, step: int) -> str:
        return os.path.join(self.config.checkpoint_dir, f"step_{step}")

    @staticmethod
    def _parse_step(name: str) -> int | None:
        """``step_{N}`` -> N, or None for anything unparseable (a stray ``step_final/``
        or ``step_3.bak`` must not take down resume)."""
        if not name.startswith("step_"):
            return None
        try:
            return int(name.split("_", 1)[1])
        except ValueError:
            logger.warning("ignoring non-numeric step entry %r in checkpoint dir", name)
            return None

    def _step_dirs(self) -> list[int]:
        """Completed step numbers, ascending."""
        root = self.config.checkpoint_dir
        if not os.path.isdir(root):
            return []
        steps = []
        for d in os.listdir(root):
            s = self._parse_step(d)
            if s is not None and os.path.isdir(os.path.join(root, d)) \
                    and self._step_complete(os.path.join(root, d)):
                steps.append(s)
        return sorted(steps)

    def latest_step(self) -> int | None:
        root = self.config.checkpoint_dir
        link = os.path.join(root, "latest")
        if os.path.islink(link):
            target = os.path.basename(os.readlink(link))
            s = self._parse_step(target)
            # the pointer counts only when it resolves to a committed step; a dangling
            # or stale link falls through to the scan
            if s is not None and self._step_complete(os.path.join(root, target)):
                return s
            if s is not None:
                logger.warning("latest symlink -> %s is dangling or incomplete; "
                               "falling back to a directory scan", target)
        steps = self._step_dirs()
        return steps[-1] if steps else None

    @staticmethod
    def _step_complete(d: str) -> bool:
        """True when the step's parameters committed and no save is still marked on it:
        a kill after the tensors land but before the manifest leaves a complete-looking
        directory that only the ``.saving`` marker shows to be torn."""
        if not os.path.exists(os.path.join(d, "model", _DCP_METADATA)):
            return False
        return not os.path.exists(os.path.join(d, SAVING_MARKER))

    # -- save ---------------------------------------------------------------
    def save(self, step: int, params: Mapping[str, torch.Tensor], opt_state: Any = None,
             client_states: Mapping[str, Any] | None = None,
             consolidated: bool | None = None,
             hf_params: Mapping[str, torch.Tensor] | None = None) -> str:
        """Write step ``step``; ``consolidated`` overrides ``config.save_consolidated`` for
        this save. ``hf_params``: what the consolidated export writes instead of
        ``params`` (under PEFT ``params`` is the adapter, ``hf_params`` the merged
        model). Returns the step directory ("" when checkpointing is off)."""
        if not self.config.enabled:
            return ""
        d = self.step_dir(step)
        os.makedirs(d, exist_ok=True)
        # save-intent marker: removed only after the manifest commits (wait()), so a
        # directory still carrying it is torn by construction
        with open(os.path.join(d, SAVING_MARKER), "w", encoding="utf-8") as f:
            f.write(str(step))
        model_dir = os.path.join(d, "model")
        if os.path.isdir(model_dir):  # an earlier save of this step: replace it whole
            shutil.rmtree(model_dir)
        with_retry(_dcp, "save", _detached(params), model_dir, config=self._retry,
                   description="model save")
        if opt_state is not None:
            optim_dir = os.path.join(d, "optim")
            if os.path.isdir(optim_dir):
                shutil.rmtree(optim_dir)
            with_retry(_dcp, "save", flatten_state(opt_state), optim_dir, config=self._retry,
                       description="optimizer save")
        if client_states:
            _write_json_atomic(os.path.join(d, "client.json"), {
                k: v.state_dict() if hasattr(v, "state_dict") else v
                for k, v in client_states.items()})
        sig: dict[str, Any] = _model_signature(params)
        if self.topology is not None:
            sig[TOPOLOGY_KEY] = self.topology
        _write_json_atomic(os.path.join(d, "signature.json"), sig)
        do_consolidated = (self.config.save_consolidated if consolidated is None
                           else consolidated)
        if do_consolidated and self.state_dict_adapter is not None:
            self.save_hf(os.path.join(d, "hf"), params if hf_params is None else hf_params)
        self._pending = step
        self.wait()
        self._prune()
        logger.info("saved checkpoint step=%d -> %s", step, d)
        return d

    def save_hf(self, out_dir: str, params: Mapping[str, torch.Tensor]) -> None:
        """Consolidated HF safetensors, one tensor on the host at a time (the adapter's
        lazy views), and the HF config.json."""
        from automodel_tpu_torch.checkpoint.safetensors_io import save_safetensors

        save_safetensors(self.state_dict_adapter.to_hf_lazy(params), out_dir)
        if self.hf_config is not None:
            with open(os.path.join(out_dir, "config.json"), "w") as f:
                json.dump(self.hf_config, f, indent=2)

    def wait(self) -> None:
        """Commit a finished save: manifest, then the marker off, then ``latest``."""
        if self._pending is None:
            return
        d = self.step_dir(self._pending)
        if self.config.write_manifest:
            write_manifest(d, step=self._pending)
        marker = os.path.join(d, SAVING_MARKER)
        if os.path.exists(marker):
            os.unlink(marker)
        self._update_latest(self._pending)
        self._pending = None

    # -- load ---------------------------------------------------------------
    def load(self, params: Mapping[str, torch.Tensor], opt_state: Any = None,
             step: int | None = None, verify: bool | None = None) -> dict[str, Any]:
        """Restore step ``step`` (default: the latest) in place into ``params`` and
        ``opt_state`` and return the client states.

        ``verify`` (default ``config.verify_on_load``) checks the integrity manifest
        before any tensor is touched, so a failed verification (ValueError) leaves the
        tensors as they were; a step from before manifests loads unverified. A
        different model raises :class:`ModelSignatureMismatch`, a different mesh
        NotImplementedError."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.config.checkpoint_dir!r}")
        d = self.step_dir(step)
        if self.config.verify_on_load if verify is None else verify:
            if has_manifest(d):
                problems = verify_manifest(d)
                if problems:
                    raise ValueError(f"checkpoint at {d!r} failed integrity verification: "
                                     f"{problems[:5]}{' ...' if len(problems) > 5 else ''}")
            else:
                logger.warning("checkpoint at %s has no integrity manifest; loading unverified", d)
        sig_path = os.path.join(d, "signature.json")
        if os.path.exists(sig_path):
            with open(sig_path) as f:
                saved, saved_topo = strip_topology(json.load(f))
            current = _model_signature(params)
            if saved != current:
                missing = sorted(set(saved) - set(current))[:5]
                added = sorted(set(current) - set(saved))[:5]
                changed = sorted(k for k in set(saved) & set(current)
                                 if saved[k] != current[k])[:5]
                raise ModelSignatureMismatch(
                    f"checkpoint at {d!r} was saved from a different model signature: "
                    f"missing={missing} added={added} changed={changed} (first 5 each; did "
                    "the model config change between save and resume?)")
            delta = mesh_delta(saved_topo, self.topology)
            if delta:
                raise NotImplementedError(
                    f"checkpoint at {d!r} was saved on another mesh ({describe_delta(delta)}):"
                    " elastic resume is not ported to the PyTorch package yet (ROADMAP.md)")
        with_retry(_dcp, "load", _detached(params), os.path.join(d, "model"),
                   config=self._retry, description="model restore")
        if opt_state is not None and os.path.isdir(os.path.join(d, "optim")):
            with_retry(_dcp, "load", flatten_state(opt_state), os.path.join(d, "optim"),
                       config=self._retry, description="optimizer restore")
        client: dict[str, Any] = {}
        cj = os.path.join(d, "client.json")
        if os.path.exists(cj):
            try:
                with open(cj) as f:
                    client = json.load(f)
            except (ValueError, OSError) as e:
                # the tensors are intact: resume with fresh host state
                logger.warning("unreadable client.json at %s (%s: %s); resuming without "
                               "scheduler/dataloader state", cj, type(e).__name__, e)
        return client

    # -- verified / fallback restore ----------------------------------------
    def verify_step(self, step: int) -> list[str]:
        """Integrity problems of a step (empty: verified, or complete without a manifest)."""
        d = self.step_dir(step)
        if not self._step_complete(d):
            return [f"incomplete step dir {d!r}"]
        if not has_manifest(d):
            return []
        return verify_manifest(d)

    def newest_verifiable_step(self, exclude: set[int] | None = None) -> int | None:
        """The newest complete step that passes verification, walking back."""
        exclude = exclude or set()
        for s in reversed(self._step_dirs()):
            if s in exclude:
                continue
            problems = self.verify_step(s)
            if not problems:
                return s
            logger.warning("checkpoint step %d fails verification (%s); walking back",
                           s, problems[:3])
        return None

    def load_latest_verified(self, params: Mapping[str, torch.Tensor], opt_state: Any = None
                             ) -> tuple[dict[str, Any], int] | None:
        """Restore in place the newest checkpoint that verifies, walking back through
        older steps on corruption. Returns ``(client, step)``, or None when nothing is
        restorable (a fresh run)."""
        exclude: set[int] = set()
        while True:
            step = self.newest_verifiable_step(exclude)
            if step is None:
                return None
            try:
                return self.load(params, opt_state, step=step), step
            except ModelSignatureMismatch:
                raise  # an older step of the same run cannot fix a different model
            except ValueError as e:
                logger.warning("restore of step %d failed (%s); trying an older step", step, e)
                exclude.add(step)

    # -- best tracking --------------------------------------------------------
    def _read_best(self) -> dict | None:
        best_path = os.path.join(self.config.checkpoint_dir, "best.json")
        if not os.path.exists(best_path):
            return None
        try:
            with open(best_path) as f:
                return json.load(f)
        except (ValueError, OSError):
            logger.warning("unreadable best.json at %s; ignoring", best_path)
            return None

    def is_best(self, val_loss: float) -> bool:
        """Would this validation loss improve on the recorded best? (read-only)"""
        best = self._read_best()
        return best is None or float(val_loss) < best["val_loss"]

    def mark_best(self, step: int, val_loss: float) -> bool:
        """Record a validation result; when it improves on the best so far, persist it
        and point the ``best`` symlink at the step. Call after the step is saved."""
        if not self.config.enabled or not self.is_best(val_loss):
            return False
        root = self.config.checkpoint_dir
        os.makedirs(root, exist_ok=True)
        _write_json_atomic(os.path.join(root, "best.json"),
                           {"step": step, "val_loss": float(val_loss)})
        _replace_symlink(os.path.join(root, "best"), f"step_{step}")
        logger.info("new best checkpoint: step=%d val_loss=%.6f", step, val_loss)
        return True

    def best_step(self) -> int | None:
        best = self._read_best()
        return None if best is None else int(best["step"])

    # -- internals ------------------------------------------------------------
    def _update_latest(self, step: int) -> None:
        _replace_symlink(os.path.join(self.config.checkpoint_dir, "latest"), f"step_{step}")

    def _prune(self) -> None:
        k = self.config.keep_last_k
        if not k:
            return
        root = self.config.checkpoint_dir
        steps = sorted(s for d in os.listdir(root) if os.path.isdir(os.path.join(root, d))
                       and (s := self._parse_step(d)) is not None)
        best = self.best_step()
        for s in steps[:-k]:
            if s != best:  # the best checkpoint survives pruning
                shutil.rmtree(self.step_dir(s), ignore_errors=True)


def _dcp(op: str, state: dict[str, torch.Tensor], path: str) -> None:
    """``torch.distributed.checkpoint`` save or in-place load of one flat state dict, by
    this process alone."""
    import torch.distributed.checkpoint as dcp

    with warnings.catch_warnings():
        # with no process group it says it assumes one process, which is the intent
        warnings.filterwarnings("ignore", message="torch.distributed is disabled")
        getattr(dcp, op)(state, checkpoint_id=path)


def _detached(params: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The parameters as plain tensors sharing their storage (a load writes through)."""
    return {k: v.detach() for k, v in params.items()}


def _replace_symlink(link: str, target: str) -> None:
    tmp = link + ".tmp"
    if os.path.islink(tmp) or os.path.exists(tmp):
        os.remove(tmp)
    os.symlink(target, tmp)
    os.replace(tmp, link)


def _write_json_atomic(path: str, obj: Any) -> None:
    """tmp + os.replace: readers see the old file or the new one, never half of one."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def _model_signature(params: Mapping[str, torch.Tensor]) -> dict[str, str]:
    """name -> "shape/dtype" of every parameter."""
    return {k: f"{tuple(v.shape)}/{str(v.dtype).removeprefix('torch.')}"
            for k, v in params.items()}
