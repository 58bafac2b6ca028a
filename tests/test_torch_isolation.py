"""The port stands alone: it imports neither JAX, the JAX package nor
PyYAML (the card's machine has none of them), its kernel modules import
without a CUDA toolkit, and its entry points refuse to fall back to the CPU
silently."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "conan_fgw_tpu_torch"
# anywhere in a line: the word jax or a dotted path into the JAX package
NAMED = re.compile(r"\bjax\b|\bconan_fgw_tpu\.")
# in an import statement: any of the JAX stack, PyYAML or the JAX package
IMPORTED = re.compile(r"\b(jax|flax|optax|yaml)\b|\bconan_fgw_tpu\b(?!_)")


DEMO = ROOT / "examples" / "fgw_parity_demo_torch.py"


def _sources():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py", DEMO]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_source_names_no_jax(path):
    for n, line in enumerate(path.read_text().splitlines(), 1):
        where = f"{path.name}:{n}: {line.strip()}"
        assert not NAMED.search(line), where
        if re.match(r"\s*(import|from)\s", line):
            assert not IMPORTED.search(line), where


def test_package_imports_with_jax_blocked():
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in PKG.rglob("*.py")
    )
    code = (
        "import sys\n"
        "for name in ('jax', 'flax', 'optax', 'yaml', 'conan_fgw_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import importlib, importlib.util\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        f"spec = importlib.util.spec_from_file_location('demo', {str(DEMO)!r})\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "print('ok')\n"
    )
    env = {**os.environ, "PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT)}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_kernel_modules_import_without_nvcc(monkeypatch):
    from conan_fgw_tpu_torch.ops.cuda import _build, cfconv, fgw  # noqa: F401

    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    from conan_fgw_tpu_torch.data.synthetic import random_dataset
    from conan_fgw_tpu_torch.device import resolve_device
    from conan_fgw_tpu_torch.models.heads import ConanModel

    for call in (resolve_device, ConanModel, lambda: random_dataset(0, 1)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert resolve_device("cpu").type == "cpu"
    assert torch.backends.cuda.matmul.allow_tf32 is False
