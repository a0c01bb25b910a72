"""CLI argument parsing with dotted config overrides (counterpart of
``automodel_tpu/config/cli_overrides.py``): a recipe accepts
``-c/--config path.yaml`` plus any number of ``--section.key value`` overrides
(``--flag`` with no value sets True; ``--key=value`` also accepted).
"""

from __future__ import annotations

import sys
from typing import Sequence

from automodel_tpu_torch.config.loader import ConfigNode, load_config, translate_value

__all__ = ["parse_args_and_load_config", "parse_cli_argv"]


def _normalize_key(key: str) -> str:
    """``--micro-batch-size`` and ``--micro_batch_size`` address the same key."""
    return ".".join(seg.replace("-", "_") for seg in key.split("."))


def parse_cli_argv(argv: Sequence[str]) -> tuple[str | None, list[tuple[str, object]]]:
    """Split argv into (config_path, [(dotted_key, value), ...])."""
    config_path: str | None = None
    overrides: list[tuple[str, object]] = []
    i = 0
    argv = list(argv)
    while i < len(argv):
        arg = argv[i]
        if arg in ("-c", "--config"):
            if i + 1 >= len(argv):
                raise ValueError(f"{arg} requires a value")
            config_path = argv[i + 1]
            i += 2
        elif arg.startswith("--"):
            key = arg[2:]
            if "=" in key:
                key, raw = key.split("=", 1)
                overrides.append((_normalize_key(key), translate_value(raw)))
                i += 1
            elif i + 1 < len(argv) and not argv[i + 1].startswith("--"):
                overrides.append((_normalize_key(key), translate_value(argv[i + 1])))
                i += 2
            else:
                overrides.append((_normalize_key(key), True))
                i += 1
        else:
            raise ValueError(f"unexpected positional argument {arg!r}")
    return config_path, overrides


def parse_args_and_load_config(argv: Sequence[str] | None = None, default_config: str | None = None) -> ConfigNode:
    """Parse ``-c cfg.yaml --a.b.c v ...`` and return the merged ConfigNode."""
    if argv is None:
        argv = sys.argv[1:]
    config_path, overrides = parse_cli_argv(argv)
    if config_path is None:
        config_path = default_config
    if config_path is None:
        raise ValueError("no config file given (use -c/--config)")
    cfg = load_config(config_path)
    for key, value in overrides:
        cfg.set_by_path(key, value)
    return cfg
