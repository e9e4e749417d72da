"""The port imports neither JAX nor the JAX package, nor TensorFlow, nltk
or cv2 (the machine with the card has none; the port keeps its own
Treebank rules, its own RGB<->HSV, its own cv2-exact resize and its own
TensorFlow checkpoint reader): an AST walk over every module of
``cap2det_tpu_torch/`` and over ``chip_smoke.py``.

The run scripts start their steps by module name (``-m`` takes a
string, which the import walk does not see), so no string of
``cap2det_tpu_torch/scripts/`` other than a docstring may name a module
of the JAX package, a file under ``tools/`` or a shell script under
``scripts/``.
"""

import ast
import pathlib
import re

import pytest
import torch

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "orbax", "cap2det_tpu", "nltk", "cv2",
             "tensorflow")
SOURCES = sorted((ROOT / "cap2det_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
SCRIPTS = sorted((ROOT / "cap2det_tpu_torch" / "scripts").glob("*.py"))
FORBIDDEN_STRING = re.compile(
    r"\bcap2det_tpu\.|(?<!cap2det_tpu_torch/)(?<![\w.])tools/"
    r"|\bscripts/[\w./-]*\.sh\b")


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
              "import cap2det_tpu_torch.data\nfrom . import z\n"
              "from nltk.tokenize import TreebankWordTokenizer\n"
              "import cv2\n"
              "from tensorflow.python.training import py_checkpoint_reader\n"
              "import tensorflow as tf\n")
    assert forbidden_imports(source) == [
        (1, "jax"), (2, "jax.numpy"), (3, "jaxlib"), (4, "orbax.checkpoint"),
        (5, "cap2det_tpu.data"), (6, "cap2det_tpu"), (11, "nltk.tokenize"),
        (12, "cv2"), (13, "tensorflow.python.training"), (14, "tensorflow"),
        (8, "jax")]  # ast.walk: the function's body after the top level


def forbidden_strings(source):
    """[(line, string)] of the string constants in `source`, docstrings
    aside, that name the JAX package, ``tools/`` or ``scripts/*.sh``."""
    tree = ast.parse(source)
    docstrings = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and isinstance(
                    first.value, ast.Constant):
                docstrings.add(id(first.value))
    return [(node.lineno, node.value) for node in ast.walk(tree)
            if isinstance(node, ast.Constant) and isinstance(node.value, str)
            and id(node) not in docstrings
            and FORBIDDEN_STRING.search(node.value)]


@pytest.mark.parametrize("path", SCRIPTS,
                         ids=[str(p.relative_to(ROOT)) for p in SCRIPTS])
def test_no_script_starts_the_jax_package(path):
    assert forbidden_strings(path.read_text()) == []


def test_the_string_guard_catches_each_form():
    source = ('"""Counterpart of scripts/train.sh and cap2det_tpu.cli."""\n'
              'a = "cap2det_tpu.cli.train_main"\n'
              'b = ["python", "tools/create_vocab.py"]\n'
              'c = "bash scripts/quality_run.sh"\n'
              'd = "cap2det_tpu_torch.tools.create_vocab"\n'
              'e = "cap2det_tpu_torch/tools/x.py"\n'
              'def f():\n    "scripts/eval_once.sh in a docstring"\n'
              '    return f"{a} scripts/train_text.sh"\n')
    assert sorted(forbidden_strings(source)) == [
        (2, "cap2det_tpu.cli.train_main"), (3, "tools/create_vocab.py"),
        (4, "bash scripts/quality_run.sh"), (9, " scripts/train_text.sh")]
