"""The benchmark imports neither JAX nor the JAX package (top-level names
compared whole: the port's name begins with the JAX package's), and its
reference imports nothing of the port. Checked on the sources (AST)."""

import ast
import os

import pytest

from benchmark import run as H

FORBIDDEN = ("jax", "jaxlib", "flax", "efficientvlm_tpu")


def files(sub=""):
    out = []
    for dirpath, _, names in os.walk(os.path.join(H.HERE, sub)):
        out += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(out)


def imported(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) in (
                "import_module", "__import__"):
            for arg in node.args[:1]:
                if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                    yield arg.value


@pytest.mark.parametrize("path", files(), ids=lambda p: os.path.relpath(p, H.HERE))
def test_no_jax(path):
    bad = [m for m in imported(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


@pytest.mark.parametrize("path", files("reference"), ids=lambda p: os.path.relpath(p, H.HERE))
def test_reference_imports_nothing_of_the_port(path):
    bad = [m for m in imported(path) if m.split(".")[0] == "efficientvlm_tpu_torch"
           or m.startswith("benchmark.") and not m.startswith("benchmark.reference")]
    assert not bad, bad


def test_forbidden_names_compare_whole():
    assert H.forbidden_modules(["efficientvlm_tpu_torch.ops.basic", "numpy", "jaxtyping"]) == []
    assert H.forbidden_modules(["jax.numpy", "efficientvlm_tpu.models", "flax"]) == [
        "efficientvlm_tpu", "flax", "jax"]
