"""The port stands alone: no file of efficientvlm_tpu_torch/, and not
chip_smoke.py, imports jax or the JAX package. Checked on the source (AST),
because the test interpreter itself may have imported jax at start-up."""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "efficientvlm_tpu")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "efficientvlm_tpu_torch")):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__" \
                or isinstance(node, ast.Call) and getattr(node.func, "attr", None) == \
                "import_module":
            for arg in node.args[:1]:
                if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                    yield arg.value


def test_the_port_has_its_files():
    files = _port_files()
    assert os.path.exists(files[0]) and len(files) > 10


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_port_file_imports_neither_jax_nor_the_jax_package(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def _csrc_joins(path):
    """The first argument of every os.path.join(..., "csrc", ...) call."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "join" and any(
                isinstance(a, ast.Constant) and a.value == "csrc" for a in node.args):
            yield ast.unparse(node.args[0])


def test_port_builds_only_its_own_native_sources():
    """The native sources the port builds (the CUDA kernels and the JPEG
    decoder, csrc/fastjpeg.cpp) are its own copies under
    efficientvlm_tpu_torch/csrc/: every path to a csrc/ starts at the
    package directory, no source includes a header from outside it, and no
    file names the JAX package's directory as a string."""
    from efficientvlm_tpu_torch.data import fastjpeg
    from efficientvlm_tpu_torch.kernels import build

    pkg = os.path.join(ROOT, "efficientvlm_tpu_torch")
    port_csrc = os.path.join(pkg, "csrc")
    assert fastjpeg.PKG_DIR == build.PKG_DIR == pkg and build.CSRC == port_csrc
    assert os.path.dirname(fastjpeg.SOURCE) == port_csrc and os.path.isfile(fastjpeg.SOURCE)
    assert os.path.commonpath([fastjpeg.BUILD_ROOT, os.path.join(ROOT, "build")]) == \
        os.path.join(ROOT, "build")
    joins = {p: list(_csrc_joins(p)) for p in _port_files()}
    assert sum(map(len, joins.values())) >= 2
    assert all(first == "PKG_DIR" for js in joins.values() for first in js), joins
    for name in os.listdir(port_csrc):
        with open(os.path.join(port_csrc, name)) as f:
            local = [line.split('"')[1] for line in f if line.startswith('#include "')]
        assert all(os.path.isfile(os.path.join(port_csrc, h)) for h in local), (name, local)
    for path in _port_files():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        names = [n.value for n in ast.walk(tree) if isinstance(n, ast.Constant)
                 and isinstance(n.value, str) and n.value.rstrip("/") in FORBIDDEN]
        assert not names, f"{os.path.relpath(path, ROOT)} names {names}"
