"""Import hygiene of the PyTorch port: ``repro_torch`` imports no ``jax``
and no module of the JAX package ``repro``, neither at run time (every
module imported in a fresh interpreter) nor in its source (AST check); nor
does ``chip_smoke.py``, the script that drives the port on the GPU."""
from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

PKG = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
CHIP_SMOKE = PKG.parents[1] / "chip_smoke.py"


def _modules() -> list[str]:
    mods = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def test_package_modules_found():
    mods = _modules()
    for m in ("repro_torch", "repro_torch.launch.engine",
              "repro_torch.kernels.paged_attention",
              "repro_torch.kernels.nbl_linear",
              "repro_torch.kernels.flash_attention",
              "repro_torch.kernels.cov_accum", "repro_torch.core.calibrate",
              "repro_torch.core.moments", "repro_torch.core.cca",
              "repro_torch.core.lmmse", "repro_torch.core.selection",
              "repro_torch.core.api", "repro_torch.core.drop",
              "repro_torch.data.synthetic", "repro_torch.eval.perplexity",
              "repro_torch.interop"):
        assert m in mods


def test_runtime_imports_no_jax_or_repro():
    code = (
        "import importlib, sys, json\n"
        f"mods = {_modules()!r}\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(json.dumps(bad))\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(PKG.parent) + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _bad_imports(path: Path) -> list[str]:
    """Every import of jax, jaxlib or repro in the file, at any depth."""
    bad = []
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        bad += [f"{path.name}:{node.lineno} {n}" for n in names
                if _forbidden(n)]
    return bad


def test_source_imports_no_jax_or_repro():
    assert [b for p in sorted(PKG.rglob("*.py")) for b in _bad_imports(p)] \
        == []


def test_chip_smoke_imports_no_jax_or_repro():
    assert CHIP_SMOKE.is_file()
    assert _bad_imports(CHIP_SMOKE) == []
