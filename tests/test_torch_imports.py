"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package ``repro`` (an AST scan,
so nothing is imported to check it)."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
_BANNED_ROOTS = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def test_port_files_exist():
    assert (ROOT / "chip_smoke.py").exists()
    assert len(PORT_FILES) > 20


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_reference_imports(path):
    bad = [name for name in _imported_roots(path)
           if name.split(".")[0] in _BANNED_ROOTS]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scanner_catches_banned_imports(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import jax.numpy as jnp\nfrom repro.core import ops\n"
                 "import importlib\nimportlib.import_module('repro.x')\n"
                 "from repro_torch.core import ops as fine\n")
    roots = [n.split(".")[0] for n in _imported_roots(f)]
    assert roots.count("jax") == 1 and roots.count("repro") == 2
