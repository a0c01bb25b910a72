"""Single-device SFT recipe (counterpart of ``automodel_tpu/recipes/llm/train_ft.py``).

Ported: the model built from ``model.config`` (an HF config dict), ``model.params_dtype``,
the loss choice with the JAX recipe's default rule, the data path, the accumulating
train step with its optimizer and LR schedule, and ``training.jsonl`` rows.

Runs on ``device`` (default ``cuda``). With no card it raises unless the config says
``device: cpu``. Sections this slice does not port (a mesh larger than one device,
PEFT, QAT, MoE, PP, checkpointing, validation, packing, resilience and observability
services, pretrained weights) raise NotImplementedError.
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
from automodel_tpu_torch.data.loader import DataLoader
from automodel_tpu_torch.loggers.metric_logger import MetricLogger
from automodel_tpu_torch.models.common.backend import DTYPES, BackendConfig
from automodel_tpu_torch.models.common.transformer import resolve_unembed
from automodel_tpu_torch.models.llama.model import LlamaConfig, LlamaForCausalLM
from automodel_tpu_torch.ops.losses import linear_cross_entropy, masked_cross_entropy
from automodel_tpu_torch.optim.builder import build_optimizer
from automodel_tpu_torch.optim.scheduler import build_lr_schedule
from automodel_tpu_torch.training.step_scheduler import StepScheduler
from automodel_tpu_torch.training.train_step import make_train_step
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


def _unsupported(cfg: ConfigNode) -> list[str]:
    """The config options this slice does not port, as readable names."""
    found = []
    for axis in ("pp", "dp_replicate", "ep", "cp", "tp"):
        if int(cfg.get(f"distributed.{axis}", 1) or 1) > 1:
            found.append(f"distributed.{axis} > 1")
    if int(cfg.get("distributed.dp_shard", 1) or 1) not in (1, -1):
        found.append("distributed.dp_shard > 1")
    for key in ("peft", "qat", "validation_dataset", "tuned_config", "tokenizer",
                "model.pretrained_model_name_or_path"):
        if cfg.get(key) is not None:
            found.append(key)
    if cfg.get("checkpoint.enabled", True):
        found.append("checkpoint.enabled (set it to false)")
    for key in ("resilience.enabled", "observability.enabled", "dataloader.prefetch.enabled"):
        if cfg.get(key):
            found.append(key)
    if int(cfg.get("packed_sequence.packed_sequence_size", 0) or 0) > 0:
        found.append("packed_sequence")
    arch = "".join(cfg.get("model.config.architectures") or [])
    if "Moe" in arch or any(cfg.get(f"model.config.{k}") for k in ("num_experts",
                                                                    "n_routed_experts")):
        found.append("MoE models")
    return found


class TrainFinetuneRecipeForNextTokenPrediction:
    def __init__(self, cfg: ConfigNode):
        self.cfg = cfg

    # ------------------------------------------------------------------ setup
    def setup(self):
        cfg = self.cfg
        logging.basicConfig(level=cfg.get("log_level", "INFO"))
        self.device = resolve_device(cfg.get("device", "cuda"))
        bad = _unsupported(cfg)
        if bad:
            raise NotImplementedError(
                f"not ported to the PyTorch package yet: {', '.join(bad)} (see ROADMAP.md)")
        seed = int(cfg.get("seed", 42))

        backend_cfg = cfg.get("backend")
        self.backend = BackendConfig(**backend_cfg.to_dict()) if backend_cfg else BackendConfig()
        model_cfg = cfg.get("model.config")
        if model_cfg is None:
            raise ValueError("config needs model.config (an HF config dict)")
        self.hf_config = model_cfg.to_dict() if isinstance(model_cfg, ConfigNode) else dict(model_cfg)
        config = LlamaConfig.from_hf(self.hf_config)

        # loss selection, with the JAX recipe's default: big vocabularies take the
        # fused linear CE, whose kernels are not ported, so on the card it raises
        default_loss = "linear_ce" if config.vocab_size >= 65536 else "masked_ce"
        self.loss_name = cfg.get("loss.name", default_loss)
        if self.loss_name not in ("masked_ce", "linear_ce"):
            raise NotImplementedError(f"loss {self.loss_name!r} is not ported yet")
        if self.loss_name == "linear_ce" and self.device.type != "cpu":
            raise NotImplementedError(
                "loss linear_ce needs the fused linear-CE kernels, not ported to CUDA yet "
                "(ROADMAP.md Queue 2: linear_ce); set loss.name: masked_ce")

        params_dtype = DTYPES[cfg.get("model.params_dtype", "float32")]
        generator = torch.Generator(device=self.device).manual_seed(seed)
        self.model = LlamaForCausalLM(config, self.backend, device=self.device,
                                      dtype=params_dtype, generator=generator)
        self.params = self.model.param_dict()
        n_params = sum(p.numel() for p in self.params.values())
        logger.info("model: LlamaForCausalLM (%.1fM params) on %s", n_params / 1e6, self.device)

        self.micro_batch_size = int(cfg.get("micro_batch_size", 1))
        self.seq_len = int(cfg.get("seq_len", 1024))
        ds_cfg = cfg.get("dataset")
        if ds_cfg is None:
            raise ValueError("config needs a dataset section")
        self.dataloader = DataLoader(
            ds_cfg.instantiate(), batch_size=self.micro_batch_size,
            collate_fn=lambda exs: sft_collate(exs, seq_len=self.seq_len, pad_token_id=0),
            seed=seed, shuffle=True)

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

    def _forward_loss(self, batch, num_label_tokens):
        out = self.model(batch["input_ids"], positions=batch["positions"],
                         segment_ids=batch["segment_ids"],
                         return_hidden=self.loss_name == "linear_ce")
        if self.loss_name == "linear_ce":
            unembed = resolve_unembed(self.model.config, self.params, out.dtype)
            return linear_cross_entropy(out, unembed, batch["labels"], num_label_tokens)
        return masked_cross_entropy(out, batch["labels"], num_label_tokens)

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
                self.metric_logger.log(
                    step, loss=loss, grad_norm=float(m["grad_norm"]),
                    lr=self.lr_schedule(step), num_label_tokens=int(m["num_label_tokens"]),
                    step_time_s=round(dt, 4), tps=round(tps, 1), tps_per_chip=round(tps, 1),
                    tflops_per_chip=round(tps * self._flops_per_token / 1e12, 2),
                    mfu=None if util is None else round(util, 4))
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
