"""The PyTorch package and chip_smoke.py stand alone: they import neither JAX nor
anything of automodel_tpu, and call no library attention kernel or compiler (SDPA
appears only in chip_smoke's timing yardstick). Every module also imports without
safetensors, transformers and datasets, which the card machine does not have: those
are imported only inside the functions that need them."""

import ast
import os
import pkgutil
import subprocess
import sys

import automodel_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "automodel_tpu_torch")
SMOKE = os.path.join(ROOT, "chip_smoke.py")

_PROBE = r"""
import importlib, pkgutil, sys
for name in ("jax", "safetensors", "transformers", "datasets"):
    sys.modules[name] = None  # any `import jax` (...) now raises
sys.path.insert(0, {root!r})
import automodel_tpu_torch
names = [m.name for m in pkgutil.walk_packages(automodel_tpu_torch.__path__, "automodel_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
from automodel_tpu_torch.config.loader import ConfigNode
ConfigNode({{"_target_": "automodel_tpu.data.llm.mock.MockSFTDataset", "vocab_size": 8,
            "seq_len": 4}}).instantiate()
import tempfile, torch
from automodel_tpu_torch.checkpoint.safetensors_io import load_safetensors, save_safetensors
with tempfile.TemporaryDirectory() as d:  # the format is read and written without the package
    save_safetensors({{"a": torch.ones(3, dtype=torch.bfloat16)}}, d)
    assert torch.equal(load_safetensors(d)["a"], torch.ones(3, dtype=torch.bfloat16))
bad = sorted(m for m in sys.modules if m == "automodel_tpu" or m.startswith("automodel_tpu.")
             or m.split(".")[0] in ("jax", "safetensors", "transformers", "datasets")
             and sys.modules[m] is not None)
print(len(names), bad)
"""


def _sources():
    files = [SMOKE]
    for dirpath, _, names in os.walk(PKG):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return files


def test_imports_without_jax_or_the_jax_package():
    out = subprocess.run([sys.executable, "-c", _PROBE.format(root=ROOT)], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    n_modules, bad = out.stdout.split(" ", 1)
    assert int(n_modules) >= 20
    assert bad.strip() == "[]"


def test_no_forbidden_imports_or_library_kernels():
    for path in _sources():
        tree = ast.parse(open(path).read(), path)
        allowed = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.FunctionDef) and node.name == "_library_sdpa":
                allowed |= {id(n) for n in ast.walk(node)}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                roots = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                roots = [(node.module or "").split(".")[0]]
            else:
                roots = []
            for root in roots:
                assert root not in ("jax", "jaxlib", "automodel_tpu", "flax", "optax"), \
                    f"{path}:{node.lineno} imports {root}"
                # only inside a function: the card machine does not have these packages
                if root in ("safetensors", "transformers", "datasets", "tokenizers"):
                    assert node.col_offset > 0, f"{path}:{node.lineno} imports {root} at the top"
            if isinstance(node, ast.Attribute) and id(node) not in allowed:
                assert node.attr != "scaled_dot_product_attention", f"{path}:{node.lineno}"
                torch_compile = (node.attr == "compile" and isinstance(node.value, ast.Name)
                                 and node.value.id == "torch")
                assert not torch_compile, f"{path}:{node.lineno} calls torch.compile"
        assert "cudnn" not in open(path).read().lower() or path == SMOKE, path


def test_every_module_is_walked():
    names = [m.name for m in pkgutil.walk_packages(automodel_tpu_torch.__path__,
                                                   "automodel_tpu_torch.")]
    assert "automodel_tpu_torch.ops.flash_attention" in names
    assert "automodel_tpu_torch.recipes.llm.benchmark" in names
