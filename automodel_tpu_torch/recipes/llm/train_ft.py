"""Single-device SFT recipe (counterpart of ``automodel_tpu/recipes/llm/train_ft.py``).

Ported: the model from a local HF directory (``model.pretrained_model_name_or_path``,
``models/auto.py``; a hub repo id raises) or built from ``model.config`` (an HF config
dict; the class from its ``architectures`` through ``models/registry.py``: Llama with
Qwen2 / Qwen3 / Mistral, Phi-3, Qwen3-MoE, GPT-OSS, the DeepSeek-V3 family, GPT-2; the
``_build_model_and_params`` hook, which the sequence-classification recipe overrides),
``model.params_dtype``, the loss choice with the JAX recipe's default rule
(``linear_ce`` at vocab >= 65536, with ``loss.impl`` and ``loss.filter_eps``), an MoE
model's token mask, aux-loss term, gate-bias update and ``moe_load/*`` rows
(``moe_metrics.mode``, default ``brief``), the tokenizer (``tokenizer``, with ``_target_`` or a local HF
directory), the data path with sequence packing (``packed_sequence``) and the
host / device prefetch pipeline (``dataloader.prefetch``), the accumulating train step
with its optimizer and LR schedule, ``training.jsonl`` rows, validation every
``val_every_steps`` into ``validation.jsonl`` (``validation_dataset``,
``validation_max_batches``), and checkpoints every ``ckpt_every_steps`` and at the end
(``checkpoint``: ``checkpoint/checkpointing.py``, with ``save_consolidated`` HF
safetensors and best tracking) with resume from the newest verifiable one.

PEFT (``peft``, JAX's ``_build_peft``): LoRA / DoRA adapters on the matched weights
(``peft/lora.py``), dropout from the ``lora_dropout`` stream of ``training/rng.py``,
and with ``peft.qlora`` (int8 | nf4) the matched base weights stored quantized after
the adapters are made (DoRA's magnitudes need them dense). The train step
differentiates the adapter alone, on the base merged every microbatch; the base is
frozen, so a frozen unembedding runs linear CE's dH-only kernel and frozen experts no
tgmm. Checkpoints hold the adapter and its optimizer state, ``hf/`` the merged model and
``hf_adapter/`` the HF PEFT export; validation runs on the merged model; an MoE model's
gate-bias update is off (with JAX's warning). QAT (``qat``): the matched weights
fake-quantized in the forward, from ``fake_quant_after_n_steps`` on (a second step
function before it, as JAX's two compiled steps), also under PEFT (on the base, before
the merge). The client state keeps the random streams (``rng``).

Runs on ``device`` (default ``cuda``). With no card it raises unless the config says
``device: cpu``. The ``distributed`` section builds a ``MeshContext``; on one process a
``cp`` larger than 1 folds onto the one card (``parallel/mesh.py``) and, with
``backend.context_parallel: ring``, runs ring attention over it. Sections this slice
does not port (any other mesh axis larger than one device, expert parallelism and the
``a2a`` dispatcher, PP, resilience and observability services, asynchronous saves, noisy
fake routing) raise NotImplementedError.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import time

import torch

from automodel_tpu_torch.checkpoint.checkpointing import Checkpointer, CheckpointingConfig
from automodel_tpu_torch.checkpoint.reshard import build_topology
from automodel_tpu_torch.config.cli_overrides import parse_args_and_load_config
from automodel_tpu_torch.config.loader import ConfigNode
from automodel_tpu_torch.data.collate import sft_collate, stack_batches
from automodel_tpu_torch.data.llm.packed import pack_dataset, packed_collate
from automodel_tpu_torch.data.loader import DataLoader
from automodel_tpu_torch.data.prefetch import InputPipeline, PrefetchConfig
from automodel_tpu_torch.loggers.metric_logger import MetricLogger
from automodel_tpu_torch.models.auto import AutoModelForCausalLM, load_hf_config
from automodel_tpu_torch.models.common.backend import DTYPES, BackendConfig
from automodel_tpu_torch.models.common.transformer import resolve_unembed
from automodel_tpu_torch.models.hub import resolve_pretrained_path
from automodel_tpu_torch.moe.gate import make_gate_bias_post_update
from automodel_tpu_torch.moe.metrics import compute_load_balance_metrics
from automodel_tpu_torch.ops.losses import (LINEAR_CE_IMPLS, linear_cross_entropy,
                                            masked_cross_entropy)
from automodel_tpu_torch.optim.builder import build_optimizer
from automodel_tpu_torch.optim.scheduler import build_lr_schedule
from automodel_tpu_torch.parallel.mesh import MeshAxis, MeshContext
from automodel_tpu_torch.training.rng import StatefulRNG
from automodel_tpu_torch.training.step_scheduler import StepScheduler
from automodel_tpu_torch.training.train_step import (count_label_tokens, make_eval_step,
                                                     make_train_step)
from automodel_tpu_torch.utils.flops import flops_per_token, mfu

logger = logging.getLogger(__name__)

__all__ = ["TrainFinetuneRecipeForNextTokenPrediction", "main", "resolve_device"]

_TOKEN_KEYS = ("input_ids", "q_ids", "p_ids")  # the token tensors a batch may carry


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
    for axis in ("pp", "dp_replicate", "ep", "tp"):
        if int(cfg.get(f"distributed.{axis}", 1) or 1) > 1:
            found.append(f"distributed.{axis} > 1")
    if int(cfg.get("distributed.dp_shard", 1) or 1) not in (1, -1):
        found.append("distributed.dp_shard > 1")
    if cfg.get("tuned_config") is not None:
        found.append("tuned_config")
    for key in ("resilience.enabled", "observability.enabled"):
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
    auto_model = AutoModelForCausalLM  # the loader _build_model_and_params calls
    saves_checkpoints = True

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
        self.rng = StatefulRNG(int(cfg.get("seed", 42)))
        dist_cfg = {k: int(v) for k, v in (cfg.get("distributed") or ConfigNode()).items()
                    if k in MeshAxis.ALL and v is not None}
        self.mesh = MeshContext(**dist_cfg)
        logger.info("mesh: %s%s", self.mesh.shape,
                    " (cp folded onto one card)" if self.mesh.folded else "")

        backend_cfg = cfg.get("backend")
        self.backend = BackendConfig(**backend_cfg.to_dict()) if backend_cfg else BackendConfig()
        # loss.impl "auto" runs the linear-CE kernels on the card and their plain version
        # on the CPU (ops/losses.py); a bad one raises before anything is built
        self.loss_impl = cfg.get("loss.impl", "auto")
        if self.loss_impl not in LINEAR_CE_IMPLS:
            raise ValueError(f"unknown loss.impl {self.loss_impl!r} {LINEAR_CE_IMPLS}")
        self.loss_filter_eps = cfg.get("loss.filter_eps", 1e-7)
        self._build_model_and_params()
        config = self.model.config
        self.moe = getattr(config, "moe", None)
        # the loss, with the JAX recipe's default: big vocabularies take the fused linear
        # CE, so the (tokens, vocab) logits never exist at once
        default_loss = "linear_ce" if config.vocab_size >= 65536 else "masked_ce"
        self.loss_name = cfg.get("loss.name", default_loss)
        if self.loss_name not in ("masked_ce", "linear_ce"):
            raise NotImplementedError(f"loss {self.loss_name!r} is not ported yet")

        self.params = self.model.param_dict()
        n_params = sum(p.numel() for p in self.params.values())
        logger.info("model: %s (%.1fM params) on %s", type(self.model).__name__,
                    n_params / 1e6, self.device)
        self._build_peft()
        # MoE load-balance rows, as the JAX recipe: "brief" by default for MoE models
        self.moe_metrics_mode = cfg.get("moe_metrics.mode",
                                        "brief" if self.moe is not None else None)
        if not cfg.get("moe_metrics.enabled", True):
            self.moe_metrics_mode = None

        self.micro_batch_size = int(cfg.get("micro_batch_size", 1))
        self.seq_len = int(cfg.get("seq_len", 1024))
        self.tokenizer = self._build_tokenizer()
        self.dataloader = self._build_dataloader(cfg.get("dataset"), is_train=True)
        val_cfg = cfg.get("validation_dataset")
        self.val_dataloader = self._build_dataloader(val_cfg, is_train=False) if val_cfg else None
        self.max_val_batches = cfg.get("validation_max_batches")
        if self.max_val_batches is not None:
            self.max_val_batches = int(self.max_val_batches)
        self.prefetch = PrefetchConfig.from_config(cfg.get("dataloader.prefetch"))

        ss = (cfg.get("step_scheduler") or ConfigNode()).to_dict()
        ss.setdefault("grad_acc_steps", 1)
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
        self.opt_state = self.optimizer.init(self.train_params)
        self._guard_nonfinite = bool(cfg.get("distributed.check_for_nan_in_grad", False))
        self._build_train_step()

        # checkpointing; a recipe that never saves (the benchmark) builds none
        self.checkpointer = None
        self._last_saved_step: int | None = None
        self._pipeline: InputPipeline | None = None
        if self.saves_checkpoints:
            ck = (cfg.get("checkpoint") or ConfigNode()).to_dict()
            self.checkpointer = Checkpointer(CheckpointingConfig(**ck),
                                             state_dict_adapter=self.model.state_dict_adapter(),
                                             hf_config=self.hf_config)
            self.checkpointer.topology = build_topology(self.mesh)

        out_dir = cfg.get("output_dir", None)
        if out_dir is None:
            out_dir = os.path.join("runs", f"train-{time.strftime('%Y%m%d-%H%M%S')}")
        os.makedirs(out_dir, exist_ok=True)
        self.output_dir = out_dir
        self.metric_logger = MetricLogger(os.path.join(out_dir, "training.jsonl"))
        self.val_metric_logger = MetricLogger(os.path.join(out_dir, "validation.jsonl"))
        self.device_kind = (torch.cuda.get_device_name(self.device)
                            if self.device.type == "cuda" else "cpu")
        self.metric_logger.log_header(
            torch_version=torch.__version__, device_kind=self.device_kind, n_devices=1,
            config_digest=_digest(cfg), loss_name=self.loss_name, n_params=n_params)
        # MFU needs the analytic FLOPs count; a config outside its formula (GPT-2's
        # n_embd / n_layer names) logs rows without tflops_per_chip and mfu, as JAX's
        try:
            self._flops_per_token = float(flops_per_token(self.hf_config, self.seq_len))
        except Exception:
            self._flops_per_token = None
        self._maybe_resume()

    def _build_model_and_params(self):
        """``self.model`` on ``self.device`` and ``self.hf_config``, the HF config dict it
        was built from: the weights of a local HF directory
        (``model.pretrained_model_name_or_path``) or random ones from the seed
        (``model.config``), through ``auto_model`` in ``_params_dtype()``. A recipe with
        another head (sequence classification) sets those two and ``_auto_model_kwargs``,
        as JAX's subclasses override this hook."""
        cfg = self.cfg
        kw = dict(backend=self.backend, dtype=self._params_dtype(), device=self.device,
                  **self._auto_model_kwargs())
        pretrained = cfg.get("model.pretrained_model_name_or_path")
        if pretrained:
            pretrained = resolve_pretrained_path(pretrained)
            self.hf_config = load_hf_config(pretrained)
            self.model = self.auto_model.from_pretrained(pretrained, **kw)
            return
        self.hf_config = self._model_config_dict()
        generator = torch.Generator(device=self.device).manual_seed(int(cfg.get("seed", 42)))
        self.model = self.auto_model.from_config(self.hf_config, generator=generator, **kw)

    def _params_dtype(self) -> torch.dtype:
        return DTYPES[self.cfg.get("model.params_dtype", "float32")]

    def _auto_model_kwargs(self) -> dict:
        return {}

    def _model_config_dict(self) -> dict:
        model_cfg = self.cfg.get("model.config")
        if model_cfg is None:
            raise ValueError("config needs model.pretrained_model_name_or_path or "
                             "model.config (an HF config dict)")
        return model_cfg.to_dict() if isinstance(model_cfg, ConfigNode) else dict(model_cfg)

    def _build_tokenizer(self):
        """``tokenizer._target_`` builds it; else a local HF directory (``tokenizer.
        pretrained_model_name_or_path``, or the model's) with a tokenizer_config.json;
        else none (mock data needs none)."""
        tok_cfg = self.cfg.get("tokenizer")
        if tok_cfg and "_target_" in tok_cfg:
            return tok_cfg.instantiate()
        path = ((tok_cfg or ConfigNode()).get("pretrained_model_name_or_path")
                or self.cfg.get("model.pretrained_model_name_or_path"))
        if path and os.path.exists(os.path.join(path, "tokenizer_config.json")):
            from automodel_tpu_torch.models.auto_tokenizer import AutoTokenizer

            return AutoTokenizer.from_pretrained(path)
        return None

    def _build_dataloader(self, ds_cfg, is_train: bool) -> DataLoader:
        if ds_cfg is None:
            raise ValueError("config needs a dataset section")
        try:
            dataset = (ds_cfg.instantiate(tokenizer=self.tokenizer) if self.tokenizer is not None
                       else ds_cfg.instantiate())
        except TypeError:
            dataset = ds_cfg.instantiate()  # a dataset that takes no tokenizer (mock)
        pad_id = getattr(self.tokenizer, "pad_token_id", None)
        dataset, collate = self._wrap_dataset_and_collate(dataset, 0 if pad_id is None else pad_id)
        return DataLoader(dataset, batch_size=self.micro_batch_size, collate_fn=collate,
                          seed=int(self.cfg.get("seed", 42)), shuffle=is_train)

    def _build_peft(self):
        """The LoRA / DoRA adapter (JAX's ``_build_peft``): ``train_params`` is what the
        optimizer and the checkpoints hold, the adapter under PEFT and the model's
        parameters otherwise. QLoRA quantizes the matched base weights after the adapter
        is made, and drops the module's dense copies of them."""
        peft_cfg = self.cfg.get("peft")
        self.peft = None
        self.train_params = self.params
        if peft_cfg is None:
            return
        from automodel_tpu_torch.peft.lora import (PeftConfig, count_lora_params,
                                                   init_lora_params, match_lora_paths)

        self.peft = PeftConfig.from_dict(peft_cfg.to_dict())
        axes = self.model.logical_axes()
        lora = init_lora_params(self.params, axes, self.peft,
                                self.rng.generator("lora_init", self.device))
        self.train_params = {k: v.requires_grad_() for k, v in lora.items()}
        for p in self.params.values():
            p.requires_grad_(False)
        scheme = peft_cfg.get("qlora")
        if scheme:
            from automodel_tpu_torch.quantization.qlora import quantize_params, tree_nbytes

            matched = match_lora_paths(axes, self.peft)
            before = tree_nbytes(self.params)
            self.params = quantize_params(self.params, matched, scheme)
            for name in matched:  # the forward reads the merged dict, never these
                del self.model.params[name.replace(".", "__")]
            logger.info("qlora(%s): base %.1fMB -> %.1fMB (%d tensors quantized)", scheme,
                        before / 2**20, tree_nbytes(self.params) / 2**20, len(matched))
        logger.info("peft: lora dim=%d alpha=%d dora=%s - %.2fM trainable params",
                    self.peft.dim, self.peft.alpha, self.peft.use_dora,
                    count_lora_params(self.train_params) / 1e6)

    def _qat_param_fn(self):
        """params -> a dict with the matched weights fake-quantized, or None when QAT is
        off (JAX's ``_build_qat_param_fn``: ``qat.target_modules`` matched as LoRA matches,
        ``["*"]`` meaning every linear weight)."""
        qat_cfg = self.cfg.get("qat")
        if qat_cfg is None or not qat_cfg.get("enabled", True):
            return None
        import dataclasses

        from automodel_tpu_torch.peft.lora import PeftConfig, match_lora_paths
        from automodel_tpu_torch.quantization.qat import QATConfig, fake_quant_params

        known = {f.name for f in dataclasses.fields(QATConfig)}
        qat = QATConfig(**{k: v for k, v in qat_cfg.to_dict().items() if k in known})
        matcher = PeftConfig(target_modules=qat.target_modules,
                             match_all_linear=qat.target_modules == ["*"])
        paths = sorted(match_lora_paths(self.model.logical_axes(), matcher))
        logger.info("qat: int%d fake-quant on %d weight tensors", qat.weight_bits, len(paths))
        return lambda params: fake_quant_params(params, paths, qat)

    def _loss_on(self, get_params, training: bool = True):
        """``f(batch, n)``: the loss on the dict ``get_params()`` gives at each call
        (under PEFT the base merged with the adapter, dropout only in training)."""
        if self.peft is None:
            return lambda batch, n: self._forward_loss(batch, n, training, get_params())
        from automodel_tpu_torch.peft.lora import lora_merged_loss

        generator = (self.rng.generator("lora_dropout", self.device)
                     if training and self.peft.dropout > 0.0 else None)
        return lora_merged_loss(
            lambda merged, batch, n: self._forward_loss(batch, n, training, merged),
            get_params, self.train_params, self.peft, generator)

    def _build_train_step(self):
        """The train and eval steps (JAX's ``_build_train_step``); with a delayed QAT
        start a second train step without fake quantization runs the steps before it, and
        validation follows the same switch."""
        qfn = self._qat_param_fn()
        qat_start = int(self.cfg.get("qat.fake_quant_after_n_steps") or 0) if qfn else 0
        self._qat_start_step = qat_start
        post_update = self._post_update()
        if self.peft is not None and post_update is not None:
            logger.warning("moe gate-bias update disabled under peft (base is frozen)")
            post_update = None
        plain = (lambda: None) if self.peft is None else (lambda: self.params)
        quantized = plain if qfn is None else (lambda: qfn(self.params))

        def step(get_params):
            return make_train_step(self._loss_on(get_params), self.train_params,
                                   self.optimizer, guard_nonfinite=self._guard_nonfinite,
                                   post_update=post_update)

        delayed = qfn is not None and qat_start > 0
        self._train_step = step(quantized)
        self._pre_qat_step = step(plain) if delayed else None
        # validation: pure CE, no MoE aux term, on the weights training sees at the step
        self._eval_step = make_eval_step(self._loss_on(quantized, training=False))
        self._pre_qat_eval_step = (make_eval_step(self._loss_on(plain, training=False))
                                   if delayed else None)

    def _maybe_resume(self):
        """Restore in place from the newest checkpoint that verifies (walking back past
        torn or corrupt steps); a fresh run when there is none. Under PEFT the checkpoint
        holds the adapter, restored over the base the model was loaded with."""
        if self.checkpointer is None or not self.checkpointer.config.enabled:
            return
        t0 = time.perf_counter()
        restored = self.checkpointer.load_latest_verified(self.train_params, self.opt_state)
        if restored is None:
            return
        client, step = restored
        self._apply_client_state(client)
        seconds = time.perf_counter() - t0
        logger.info("resumed from step %d in %.1f s", step, seconds)
        self.metric_logger.log(step, event="checkpoint_restore", seconds=seconds)

    def _apply_client_state(self, client: dict):
        if "rng" in client:
            self.rng.load_state_dict(client["rng"])
        if "step_scheduler" in client:
            self.step_scheduler.load_state_dict(client["step_scheduler"])
        if "dataloader" in client:
            self.dataloader.load_state_dict(client["dataloader"])

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

    def _forward_loss(self, batch, num_label_tokens, training: bool = True, params=None):
        """The microbatch's loss on ``params`` (a merged or fake-quantized dict), or on
        the model's own parameters when None."""
        kwargs = {}
        if self.moe is not None:
            # segment id 0 marks padding: pad tokens count for no routing load or aux loss
            kwargs = {"token_mask": batch["segment_ids"] != 0, "training": training}
        if params is not None:
            kwargs["params"] = params
        out = self.model(batch["input_ids"], positions=batch["positions"],
                         segment_ids=batch["segment_ids"],
                         return_hidden=self.loss_name == "linear_ce", mesh=self.mesh, **kwargs)
        out, stats = out if isinstance(out, tuple) else (out, None)
        if self.loss_name == "linear_ce":
            unembed = resolve_unembed(self.model.config,
                                      self.params if params is None else params, out.dtype)
            loss = linear_cross_entropy(out, unembed, batch["labels"], num_label_tokens,
                                        impl=self.loss_impl, filter_eps=self.loss_filter_eps)
        else:
            loss = masked_cross_entropy(out, batch["labels"], num_label_tokens)
        if stats is None or not training:
            return loss
        aux = {"expert_load": stats["expert_load"]}
        if stats["aux_loss"] is not None:
            # scaled by the microbatch's token share, undoing the 1/num_label_tokens
            # normalisation; summed over microbatches it is the token-weighted mean
            share = count_label_tokens(batch["labels"]).float() / num_label_tokens
            loss = loss + self.moe.aux_loss_coeff * stats["aux_loss"] * share
            aux["moe_aux_loss"] = (stats["aux_loss"] * share).detach()
        return loss, aux

    def _post_update(self):
        """The gate-bias loss-free balancing hook (JAX's ``_post_update``): an update of
        each MoE layer's correction bias from the step's summed expert load, or None."""
        if self.moe is None or self.moe.gate_bias_update_factor <= 0:
            return None
        return make_gate_bias_post_update(self.moe.gate_bias_update_factor)

    def _to_device(self, stack: dict) -> dict[str, torch.Tensor]:
        return {k: torch.from_numpy(v).to(self.device) for k, v in stack.items()}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------ train
    def run_train_validation_loop(self):
        saving = self.checkpointer is not None and self.checkpointer.config.enabled
        pipeline = self._pipeline = InputPipeline(self.step_scheduler, self.dataloader,
                                                  stack_batches, self._to_device, self.prefetch,
                                                  self.device)
        try:
            checked_vocab = False
            while (fetched := pipeline.get()) is not None:
                # the consumed step rides on the batch: under prefetch the scheduler's own
                # counter runs ahead
                stack, step = fetched.stack, fetched.step
                # biencoder batches carry q_ids / p_ids in place of input_ids
                token_keys = [k for k in _TOKEN_KEYS if k in stack]
                if not checked_vocab:
                    # a tokenizer / model vocab mismatch fails here, not as NaN later
                    vocab = self.model.config.vocab_size
                    for key in token_keys:
                        top = int(stack[key].max())
                        if top >= vocab:
                            raise ValueError(f"batch {key} contains token id {top} >= model "
                                             f"vocab_size {vocab}: tokenizer / model mismatch")
                    checked_vocab = True
                t0 = time.perf_counter()
                step_fn = self._train_step
                if self._pre_qat_step is not None and step < self._qat_start_step:
                    step_fn = self._pre_qat_step
                self.opt_state, m = step_fn(self.opt_state, stack)
                loss = float(m["loss"])  # host read: the step's end
                dt = time.perf_counter() - t0
                if self._guard_nonfinite and bool(m["nonfinite"]):
                    raise FloatingPointError(f"non-finite loss or gradient at step {step}")
                if self.step_scheduler.is_log_step_at(step):
                    self._log_step(step, m, loss, dt,
                                   sum(stack[k].numel() for k in token_keys), pipeline)
                if self.val_dataloader is not None and self.step_scheduler.is_val_step_at(step):
                    self._run_validation(step)
                # the best-tracking path may have just saved this very step
                if (saving and self.step_scheduler.is_ckpt_step_at(step)
                        and self._last_saved_step != step):
                    self._save(step)
            pipeline.close()
            self._pipeline = None
            # the final checkpoint, from the live objects (the data is consumed)
            if saving and self._last_saved_step != self.step_scheduler.step:
                self._save(self.step_scheduler.step)
        finally:
            pipeline.close()
            self._pipeline = None
            self.metric_logger.close()
            self.val_metric_logger.close()

    def _log_step(self, step, m, loss, dt, step_tokens, pipeline):
        tps = step_tokens / dt
        extra = {}
        if self._flops_per_token is not None:
            util = mfu(tps, self._flops_per_token, self.device_kind)
            extra = {"tflops_per_chip": round(tps * self._flops_per_token / 1e12, 2),
                     "mfu": None if util is None else round(util, 4)}
        if "expert_load" in m and self.moe_metrics_mode:
            extra.update(compute_load_balance_metrics(m["expert_load"].cpu().numpy(),
                                                      mode=self.moe_metrics_mode))
        if pipeline.prefetching:
            extra["prefetch_depth"] = pipeline.ready_depth()
        self.metric_logger.log(
            step, loss=loss, grad_norm=float(m["grad_norm"]),
            lr=self.lr_schedule(step), num_label_tokens=int(m["num_label_tokens"]),
            step_time_s=round(dt, 4), tps=round(tps, 1), tps_per_chip=round(tps, 1), **extra)

    # ------------------------------------------------------------- validation
    def _run_validation(self, step: int):
        """Token-weighted mean loss over the validation window, summed in f64 on the host."""
        eval_step = self._eval_step
        if self._pre_qat_eval_step is not None and step < self._qat_start_step:
            eval_step = self._pre_qat_eval_step
        total, count = 0.0, 0
        for batch in self._iter_val_batches():
            stack = self._to_device(batch)
            n = count_label_tokens(stack["labels"])
            n_host = int(n)
            total += float(eval_step(stack, n)) * n_host
            count += n_host
        self._log_val_loss(step, total, count)

    def _iter_val_batches(self):
        """A bounded pass over the validation loader that leaves its cursor where it was,
        so every validation pass scores the same window."""
        dl = self.val_dataloader
        state = dl.state_dict()
        try:
            yield from itertools.islice(dl, self.max_val_batches)
        finally:
            dl.load_state_dict(state)

    def _log_val_loss(self, step: int, total: float, count: int,
                      extra_sums: dict[str, float] | None = None):
        """Log ``total / count``; ``extra_sums``: other per-example sums over the same
        ``count`` (the biencoder's acc@1, recall@k and MRR), logged as their means."""
        if not count:
            return
        val_loss = total / count
        extras = {k: v / count for k, v in (extra_sums or {}).items()}
        self.val_metric_logger.log(step, val_loss=val_loss, **extras)
        logger.info("validation @ step %d: loss %.4f%s", step, val_loss,
                    "".join(f" | {k} {v:.4f}" for k, v in extras.items()))
        # best-checkpoint tracking: save the improving step and point `best` at it
        if (self.checkpointer is not None and self.checkpointer.config.enabled
                and bool(self.cfg.get("checkpoint.save_best", True))
                and self.checkpointer.is_best(val_loss)):
            self._save(step)
            self.checkpointer.mark_best(step, val_loss)

    # ----------------------------------------------------------- checkpoints
    def _save(self, step: int):
        """Save ``step``. Under prefetch the live scheduler and dataloader have run past
        the consumed step, so their consumed-position snapshots are saved instead, and a
        resume replays every batch that was in flight. Under PEFT the checkpoint holds the
        adapter; the consolidated export writes the merged model to ``hf/`` and the
        adapter alone, in the HF PEFT layout, to ``hf_adapter/``."""
        self._last_saved_step = step
        client = {"rng": self.rng, "step_scheduler": self.step_scheduler,
                  "dataloader": self.dataloader}
        if self._pipeline is not None:
            client.update(self._pipeline.client_states())
        t0 = time.perf_counter()
        consolidated = self.checkpointer.config.save_consolidated
        hf_params = None
        if self.peft is not None:
            from automodel_tpu_torch.peft.lora import merge_lora_params

            client["peft_config"] = self.peft.to_dict()
            if consolidated:
                with torch.no_grad():
                    hf_params = merge_lora_params(self.params, self.train_params, self.peft)
        d = self.checkpointer.save(step, self.train_params, self.opt_state,
                                   client_states=client, hf_params=hf_params)
        del hf_params
        if self.peft is not None and consolidated:
            from automodel_tpu_torch.checkpoint.peft_export import save_peft_adapter

            save_peft_adapter(os.path.join(d, "hf_adapter"), self.train_params, self.peft,
                              self.model.state_dict_adapter().entries,
                              base_model_name=self.cfg.get("model.pretrained_model_name_or_path"))
        seconds = time.perf_counter() - t0
        n_bytes = sum(os.path.getsize(os.path.join(root, f))
                      for root, _, files in os.walk(d) for f in files)
        self.metric_logger.log(step, event="checkpoint_save", seconds=seconds, bytes=n_bytes)


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
