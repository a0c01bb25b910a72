"""Single-device SFT recipe (counterpart of ``automodel_tpu/recipes/llm/train_ft.py``).

Ported: the model built from ``model.config`` (an HF config dict; the class from its
``architectures`` through ``models/registry.py``: Llama, Qwen3-MoE), ``model.params_dtype``,
the loss choice with the JAX recipe's default rule (``linear_ce`` at vocab >= 65536,
with ``loss.impl`` and ``loss.filter_eps``), an MoE model's token mask, aux-loss term
and ``moe_load/*`` rows (``moe_metrics.mode``, default ``brief``), the data path with
sequence packing (``packed_sequence``), the accumulating train step with its optimizer
and LR schedule, and ``training.jsonl`` rows.

Runs on ``device`` (default ``cuda``). With no card it raises unless the config says
``device: cpu``. The ``distributed`` section builds a ``MeshContext``; on one process a
``cp`` larger than 1 folds onto the one card (``parallel/mesh.py``) and, with
``backend.context_parallel: ring``, runs ring attention over it. Sections this slice
does not port (any other mesh axis larger than one device, expert parallelism and the
``a2a`` dispatcher, PEFT, QAT, PP, checkpointing,
validation, prefetching, resilience and observability services, pretrained weights,
noisy fake routing, the gate-bias update) raise NotImplementedError.
"""

from __future__ import annotations

import json
import logging
import os
import time

import torch

from automodel_tpu_torch.config.cli_overrides import parse_args_and_load_config
from automodel_tpu_torch.config.loader import ConfigNode
from automodel_tpu_torch.data.collate import sft_collate, stack_batches
from automodel_tpu_torch.data.llm.packed import pack_dataset, packed_collate
from automodel_tpu_torch.data.loader import DataLoader
from automodel_tpu_torch.loggers.metric_logger import MetricLogger
from automodel_tpu_torch.models.common.backend import DTYPES, BackendConfig
from automodel_tpu_torch.models.common.transformer import resolve_unembed
from automodel_tpu_torch.models.registry import resolve_model_class
from automodel_tpu_torch.moe.metrics import compute_load_balance_metrics
from automodel_tpu_torch.ops.losses import (LINEAR_CE_IMPLS, linear_cross_entropy,
                                            masked_cross_entropy)
from automodel_tpu_torch.optim.builder import build_optimizer
from automodel_tpu_torch.optim.scheduler import build_lr_schedule
from automodel_tpu_torch.parallel.mesh import MeshAxis, MeshContext
from automodel_tpu_torch.training.step_scheduler import StepScheduler
from automodel_tpu_torch.training.train_step import count_label_tokens, make_train_step
from automodel_tpu_torch.utils.flops import flops_per_token, mfu

logger = logging.getLogger(__name__)

__all__ = ["TrainFinetuneRecipeForNextTokenPrediction", "main", "resolve_device"]


def resolve_device(name: str) -> torch.device:
    """The run's device; a CUDA device with no card raises instead of using the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; set `device: cpu` to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r} (cuda | cpu)")
    return device


def _unsupported(cfg: ConfigNode, saves_checkpoints: bool = True) -> list[str]:
    """The config options this slice does not port, as readable names. A recipe that
    never saves (the benchmark) passes ``saves_checkpoints=False``."""
    found = []
    for axis in ("pp", "dp_replicate", "ep", "tp"):
        if int(cfg.get(f"distributed.{axis}", 1) or 1) > 1:
            found.append(f"distributed.{axis} > 1")
    if int(cfg.get("distributed.dp_shard", 1) or 1) not in (1, -1):
        found.append("distributed.dp_shard > 1")
    for key in ("peft", "qat", "validation_dataset", "tuned_config", "tokenizer",
                "model.pretrained_model_name_or_path"):
        if cfg.get(key) is not None:
            found.append(key)
    if saves_checkpoints and cfg.get("checkpoint.enabled", True):
        found.append("checkpoint.enabled (set it to false)")
    for key in ("resilience.enabled", "observability.enabled", "dataloader.prefetch.enabled"):
        if cfg.get(key):
            found.append(key)
    if cfg.get("backend.linear", "default") == "fp8":
        found.append("backend.linear fp8")
    if cfg.get("backend.dispatcher", "dense") != "dense":
        found.append(f"backend.dispatcher {cfg.get('backend.dispatcher')}")
    if float(cfg.get("backend.fake_gate_noise", 0.0) or 0.0) > 0:
        found.append("backend.fake_gate_noise > 0")
    return found


class TrainFinetuneRecipeForNextTokenPrediction:
    saves_checkpoints = True

    def __init__(self, cfg: ConfigNode):
        self.cfg = cfg

    # ------------------------------------------------------------------ setup
    def setup(self):
        cfg = self.cfg
        logging.basicConfig(level=cfg.get("log_level", "INFO"))
        self.device = resolve_device(cfg.get("device", "cuda"))
        bad = _unsupported(cfg, self.saves_checkpoints)
        if bad:
            raise NotImplementedError(
                f"not ported to the PyTorch package yet: {', '.join(bad)} (see ROADMAP.md)")
        seed = int(cfg.get("seed", 42))
        dist_cfg = {k: int(v) for k, v in (cfg.get("distributed") or ConfigNode()).items()
                    if k in MeshAxis.ALL and v is not None}
        self.mesh = MeshContext(**dist_cfg)
        logger.info("mesh: %s%s", self.mesh.shape,
                    " (cp folded onto one card)" if self.mesh.folded else "")

        backend_cfg = cfg.get("backend")
        self.backend = BackendConfig(**backend_cfg.to_dict()) if backend_cfg else BackendConfig()
        model_cfg = cfg.get("model.config")
        if model_cfg is None:
            raise ValueError("config needs model.config (an HF config dict)")
        self.hf_config = model_cfg.to_dict() if isinstance(model_cfg, ConfigNode) else dict(model_cfg)
        model_cls = resolve_model_class((self.hf_config.get("architectures")
                                         or ["LlamaForCausalLM"])[0])
        config = model_cls.config_class.from_hf(self.hf_config)
        self.moe = getattr(config, "moe", None)
        if self.moe is not None and self.moe.gate_bias_update_factor > 0:
            raise NotImplementedError("the MoE gate-bias update is not ported yet "
                                      "(the DeepSeek family, ROADMAP.md)")

        # loss selection, with the JAX recipe's default: big vocabularies take the
        # fused linear CE, so the (tokens, vocab) logits never exist at once.
        # loss.impl "auto" runs its kernels on the card and their plain version on
        # the CPU (ops/losses.py)
        default_loss = "linear_ce" if config.vocab_size >= 65536 else "masked_ce"
        self.loss_name = cfg.get("loss.name", default_loss)
        if self.loss_name not in ("masked_ce", "linear_ce"):
            raise NotImplementedError(f"loss {self.loss_name!r} is not ported yet")
        self.loss_impl = cfg.get("loss.impl", "auto")
        if self.loss_impl not in LINEAR_CE_IMPLS:
            raise ValueError(f"unknown loss.impl {self.loss_impl!r} {LINEAR_CE_IMPLS}")
        self.loss_filter_eps = cfg.get("loss.filter_eps", 1e-7)

        params_dtype = DTYPES[cfg.get("model.params_dtype", "float32")]
        generator = torch.Generator(device=self.device).manual_seed(seed)
        self.model = model_cls(config, self.backend, device=self.device, dtype=params_dtype,
                               generator=generator)
        self.params = self.model.param_dict()
        n_params = sum(p.numel() for p in self.params.values())
        logger.info("model: %s (%.1fM params) on %s", model_cls.__name__, n_params / 1e6,
                    self.device)
        # MoE load-balance rows, as the JAX recipe: "brief" by default for MoE models
        self.moe_metrics_mode = cfg.get("moe_metrics.mode",
                                        "brief" if self.moe is not None else None)
        if not cfg.get("moe_metrics.enabled", True):
            self.moe_metrics_mode = None

        self.micro_batch_size = int(cfg.get("micro_batch_size", 1))
        self.seq_len = int(cfg.get("seq_len", 1024))
        ds_cfg = cfg.get("dataset")
        if ds_cfg is None:
            raise ValueError("config needs a dataset section")
        dataset, collate = self._wrap_dataset_and_collate(ds_cfg.instantiate(), pad_id=0)
        self.dataloader = DataLoader(dataset, batch_size=self.micro_batch_size,
                                     collate_fn=collate, seed=seed, shuffle=True)

        ss = (cfg.get("step_scheduler") or ConfigNode()).to_dict()
        ss.setdefault("grad_acc_steps", 1)
        for key in ("ckpt_every_steps", "val_every_steps"):
            if int(ss.get(key) or 0) > 0:
                raise NotImplementedError(f"step_scheduler.{key} is not ported yet")
        self.step_scheduler = StepScheduler(dataloader=self.dataloader, **ss)

        opt_cfg = (cfg.get("optimizer") or ConfigNode()).to_dict()
        lr_cfg = (cfg.get("lr_scheduler") or ConfigNode()).to_dict()
        max_lr = float(opt_cfg.pop("lr", 1e-5))
        steps_per_epoch = max(len(self.dataloader) // int(ss["grad_acc_steps"]), 1)
        total_steps = ss.get("max_steps") or steps_per_epoch * int(ss.get("num_epochs", 1))
        lr_cfg.setdefault("lr_decay_steps", total_steps)
        self.lr_schedule = build_lr_schedule(max_lr=max_lr, **lr_cfg)
        betas = opt_cfg.pop("betas", (0.9, 0.95))
        self.optimizer = build_optimizer(lr=self.lr_schedule, betas=tuple(betas), **opt_cfg)
        self.opt_state = self.optimizer.init(self.params)
        self._guard_nonfinite = bool(cfg.get("distributed.check_for_nan_in_grad", False))
        self._train_step = make_train_step(self._forward_loss, self.params, self.optimizer,
                                           guard_nonfinite=self._guard_nonfinite)

        out_dir = cfg.get("output_dir", None)
        if out_dir is None:
            out_dir = os.path.join("runs", f"train-{time.strftime('%Y%m%d-%H%M%S')}")
        os.makedirs(out_dir, exist_ok=True)
        self.output_dir = out_dir
        self.metric_logger = MetricLogger(os.path.join(out_dir, "training.jsonl"))
        self.device_kind = (torch.cuda.get_device_name(self.device)
                            if self.device.type == "cuda" else "cpu")
        self.metric_logger.log_header(
            torch_version=torch.__version__, device_kind=self.device_kind, n_devices=1,
            config_digest=_digest(cfg), loss_name=self.loss_name, n_params=n_params)
        self._flops_per_token = flops_per_token(self.hf_config, self.seq_len)

    def _wrap_dataset_and_collate(self, dataset, pad_id: int):
        """Packing (the ``packed_sequence`` section) or per-example padding."""
        pack_size = int(self.cfg.get("packed_sequence.packed_sequence_size", 0) or 0)
        if pack_size <= 0:
            return dataset, (lambda exs: sft_collate(exs, seq_len=self.seq_len,
                                                     pad_token_id=pad_id))
        if not self.backend.attention_segments:
            raise ValueError(
                "packed sequences need segment masking in attention; drop "
                "backend.attention_segments: false (it is a fast path for "
                "right-padded UNPACKED batches only)")
        if pack_size % self.mesh.cp != 0:
            raise ValueError(f"packed_sequence_size {pack_size} must divide by cp={self.mesh.cp}")
        dataset = pack_dataset(
            dataset, pack_size, pad_token_id=pad_id,
            max_packs=self.cfg.get("packed_sequence.max_packs"),
            drop_long_samples=bool(self.cfg.get("packed_sequence.drop_long_samples", False)))
        self.seq_len = pack_size
        return dataset, packed_collate

    def _forward_loss(self, batch, num_label_tokens):
        kwargs = {}
        if self.moe is not None:
            # segment id 0 marks padding: pad tokens count for no routing load or aux loss
            kwargs = {"token_mask": batch["segment_ids"] != 0, "training": True}
        out = self.model(batch["input_ids"], positions=batch["positions"],
                         segment_ids=batch["segment_ids"],
                         return_hidden=self.loss_name == "linear_ce", mesh=self.mesh, **kwargs)
        out, stats = out if isinstance(out, tuple) else (out, None)
        if self.loss_name == "linear_ce":
            unembed = resolve_unembed(self.model.config, self.params, out.dtype)
            loss = linear_cross_entropy(out, unembed, batch["labels"], num_label_tokens,
                                        impl=self.loss_impl, filter_eps=self.loss_filter_eps)
        else:
            loss = masked_cross_entropy(out, batch["labels"], num_label_tokens)
        if stats is None:
            return loss
        aux = {"expert_load": stats["expert_load"]}
        if stats["aux_loss"] is not None:
            # scaled by the microbatch's token share, undoing the 1/num_label_tokens
            # normalisation; summed over microbatches it is the token-weighted mean
            share = count_label_tokens(batch["labels"]).float() / num_label_tokens
            loss = loss + self.moe.aux_loss_coeff * stats["aux_loss"] * share
            aux["moe_aux_loss"] = (stats["aux_loss"] * share).detach()
        return loss, aux

    def _to_device(self, stack: dict) -> dict[str, torch.Tensor]:
        return {k: torch.from_numpy(v).to(self.device) for k, v in stack.items()}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------ train
    def run_train_validation_loop(self):
        tokens = self.micro_batch_size * self.seq_len
        try:
            for batches in self.step_scheduler:
                stack = self._to_device(stack_batches(batches))
                t0 = time.perf_counter()
                self.opt_state, m = self._train_step(self.opt_state, stack)
                loss = float(m["loss"])  # host read: the step's end
                dt = time.perf_counter() - t0
                if self._guard_nonfinite and bool(m["nonfinite"]):
                    raise FloatingPointError(
                        f"non-finite loss or gradient at step {self.step_scheduler.step}")
                step = self.step_scheduler.step
                if not self.step_scheduler.is_log_step_at(step):
                    continue
                tps = len(batches) * tokens / dt
                util = mfu(tps, self._flops_per_token, self.device_kind)
                extra = {}
                if "expert_load" in m and self.moe_metrics_mode:
                    extra = compute_load_balance_metrics(m["expert_load"].cpu().numpy(),
                                                         mode=self.moe_metrics_mode)
                self.metric_logger.log(
                    step, loss=loss, grad_norm=float(m["grad_norm"]),
                    lr=self.lr_schedule(step), num_label_tokens=int(m["num_label_tokens"]),
                    step_time_s=round(dt, 4), tps=round(tps, 1), tps_per_chip=round(tps, 1),
                    tflops_per_chip=round(tps * self._flops_per_token / 1e12, 2),
                    mfu=None if util is None else round(util, 4), **extra)
        finally:
            self.metric_logger.close()


def _digest(cfg: ConfigNode) -> str:
    import hashlib

    raw = json.dumps(cfg.to_dict(resolve_env=False), sort_keys=True, default=str)
    return hashlib.sha256(raw.encode()).hexdigest()[:16]


def main(cfg: ConfigNode | None = None, argv=None):
    if cfg is None:
        cfg = parse_args_and_load_config(argv)
    recipe = TrainFinetuneRecipeForNextTokenPrediction(cfg)
    recipe.setup()
    recipe.run_train_validation_loop()
    return recipe


if __name__ == "__main__":
    main()
