"""Package-wide properties: every module is plain JAX/NumPy (no Pallas
kernel that would tie the engine to one accelerator), and the persistent
compilation cache lives where it is documented."""

import ast
from pathlib import Path

import pytest

import pffdtd_jax
from pffdtd_jax import utils

PKG = Path(pffdtd_jax.__file__).parent
MODULES = sorted(str(p.relative_to(PKG)) for p in PKG.rglob("*.py"))


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
            yield from (f"{node.module}.{a.name}" for a in node.names)


@pytest.mark.parametrize("module", MODULES)
def test_module_imports_no_pallas(module):
    tree = ast.parse((PKG / module).read_text())
    bad = [m for m in _imports(tree) if "pallas" in m.split(".")]
    assert not bad, f"{module} imports {bad}"


def test_compile_cache_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    d = Path(utils.compilation_cache_dir())
    assert d.name == ".jax_cache"
    assert d.parent == PKG.parent
    ignored = (PKG.parent / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored


def test_compile_cache_env_wins(monkeypatch, tmp_path):
    import jax

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert utils.compilation_cache_dir() is None
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setattr(utils, "_CACHE_DONE", False)
    utils.enable_compilation_cache()
    # JAX reads the variable itself; the program sets no directory
    assert jax.config.jax_compilation_cache_dir == before
