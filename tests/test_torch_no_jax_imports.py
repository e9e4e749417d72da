"""The port imports neither JAX nor the JAX package: an AST walk over
every module of ``cap2det_tpu_torch/`` and over ``chip_smoke.py``."""

import ast
import pathlib

import pytest
import torch

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "orbax", "cap2det_tpu")
SOURCES = sorted((ROOT / "cap2det_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def forbidden_imports(source):
    """[(line, module)] of the imports in `source` that name a forbidden
    top-level package (``cap2det_tpu_torch`` is not ``cap2det_tpu``)."""
    found = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        found += [(node.lineno, name) for name in names
                  if name.split(".")[0] in FORBIDDEN]
    return found


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_jax_import(path):
    assert forbidden_imports(path.read_text()) == []


def test_the_guard_catches_each_form():
    source = ("import jax\nimport jax.numpy as jnp\nfrom jaxlib import x\n"
              "import orbax.checkpoint\nfrom cap2det_tpu.data import y\n"
              "import cap2det_tpu\ndef f():\n    from jax import lax\n"
              "import cap2det_tpu_torch.data\nfrom . import z\n")
    assert forbidden_imports(source) == [
        (1, "jax"), (2, "jax.numpy"), (3, "jaxlib"), (4, "orbax.checkpoint"),
        (5, "cap2det_tpu.data"), (6, "cap2det_tpu"), (8, "jax")]
