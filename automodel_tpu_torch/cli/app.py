"""The ``automodel`` command line for the PyTorch package (counterpart of
``automodel_tpu/cli/app.py``)::

    python -m automodel_tpu_torch.cli.app finetune llm -c cfg.yaml [--a.b.c v ...]
    python -m automodel_tpu_torch.cli.app pretrain llm -c cfg.yaml
    python -m automodel_tpu_torch.cli.app benchmark llm -c cfg.yaml
    python -m automodel_tpu_torch.cli.app finetune seq_cls -c cfg.yaml
    python -m automodel_tpu_torch.cli.app finetune biencoder -c cfg.yaml
    python -m automodel_tpu_torch.cli.app mine biencoder -c cfg.yaml

The recipe runs in this process, on one card. The JAX package's other recipes (kd,
generate, VLM) are not ported and are refused by name, as is a config with a
``slurm:`` section (the launcher is not ported).
"""

from __future__ import annotations

import importlib
import sys

from automodel_tpu_torch.config.cli_overrides import parse_args_and_load_config

__all__ = ["RECIPES", "UNPORTED", "main"]

# (command, domain) -> recipe main
RECIPES: dict[tuple[str, str], str] = {
    ("finetune", "llm"): "automodel_tpu_torch.recipes.llm.train_ft:main",
    ("pretrain", "llm"): "automodel_tpu_torch.recipes.llm.train_ft:main",
    ("benchmark", "llm"): "automodel_tpu_torch.recipes.llm.benchmark:main",
    ("finetune", "seq_cls"): "automodel_tpu_torch.recipes.llm.train_seq_cls:main",
    ("finetune", "biencoder"): "automodel_tpu_torch.recipes.biencoder.train_biencoder:main",
    ("mine", "biencoder"): "automodel_tpu_torch.recipes.biencoder.mine_hard_negatives:main",
}
# the JAX package's recipes that have no port yet
UNPORTED = (("kd", "llm"), ("generate", "llm"), ("finetune", "vlm"))


def _resolve(command: str, domain: str):
    key = (command, domain)
    if key in UNPORTED:
        raise SystemExit(f"recipe '{command} {domain}' is not ported to the PyTorch package "
                         "yet (ROADMAP.md)")
    if key not in RECIPES:
        known = ", ".join(f"{c} {d}" for c, d in RECIPES)
        raise SystemExit(f"unknown recipe '{command} {domain}'; known: {known}")
    mod_name, fn_name = RECIPES[key].split(":")
    return getattr(importlib.import_module(mod_name), fn_name)


def main(argv: list[str] | None = None):
    if argv is None:
        argv = sys.argv[1:]
    if len(argv) < 2 or argv[0] in ("-h", "--help"):
        print(__doc__)
        raise SystemExit(0 if argv and argv[0] in ("-h", "--help") else 2)
    command, domain, *rest = argv
    recipe_main = _resolve(command, domain)
    cfg = parse_args_and_load_config(rest)
    if "slurm" in cfg:
        raise SystemExit("a slurm: section needs the launcher, which is not ported to the "
                         "PyTorch package yet (ROADMAP.md)")
    return recipe_main(cfg)


if __name__ == "__main__":
    main()
