"""Import guard for the port: no file under ``paddle_tpu_torch/``, and
neither ``chip_smoke.py`` nor ``chip_ab.py``, imports ``jax``,
``ml_dtypes`` or anything of ``paddle_tpu`` (only the tests import
both). Also pins the packaging of the port."""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "paddle_tpu", "ml_dtypes"}
FILES = sorted((ROOT / "paddle_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "chip_ab.py"]


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and ((isinstance(node.func, ast.Attribute)
                    and node.func.attr == "import_module")
                   or (isinstance(node.func, ast.Name)
                       and node.func.id == "__import__"))):
            yield node.lineno, node.args[0].value


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [(line, name) for line, name in _imported_roots(tree)
           if name.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_guard_catches_each_import_form():
    src = ("import jax.numpy as jnp\nfrom paddle_tpu.serving import x\n"
           "import importlib\nimportlib.import_module('jaxlib')\n"
           "__import__('paddle_tpu')\nimport paddle_tpu_torch\n")
    roots = [n.split(".")[0] for _, n in _imported_roots(ast.parse(src))]
    assert [r for r in roots if r in FORBIDDEN] == [
        "jax", "paddle_tpu", "jaxlib", "paddle_tpu"]


def test_importing_the_port_loads_no_jax():
    code = ("import sys\n"
            "import paddle_tpu_torch.inference, paddle_tpu_torch.serving\n"
            "import paddle_tpu_torch.models, paddle_tpu_torch.kernels\n"
            "import paddle_tpu_torch.train, paddle_tpu_torch.trainer\n"
            "import paddle_tpu_torch.optimizer, paddle_tpu_torch.models.bert\n"
            "from paddle_tpu_torch.kernels import registry\n"
            "assert registry.load_all()\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'paddle_tpu'))\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_port_is_packaged_with_its_cuda_sources():
    text = (ROOT / "pyproject.toml").read_text()
    pkgs = sorted(str(p.parent.relative_to(ROOT)).replace("/", ".")
                  for p in (ROOT / "paddle_tpu_torch").rglob("__init__.py"))
    for pkg in pkgs:
        assert f'"{pkg}"' in text, f"{pkg} missing from pyproject packages"
    assert '"paddle_tpu_torch" = ["csrc/*.cu"]' in text
    assert list((ROOT / "paddle_tpu_torch" / "csrc").glob("*.cu"))
