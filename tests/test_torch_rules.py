"""Rules the PyTorch port keeps, checked on the CPU.

- No file of gpmdm_tpu_torch/ or chip_smoke.py imports jax or gpmdm_tpu.
- The kernels are built by nvcc into a hashed, git-ignored directory and
  bound with ctypes; nothing uses torch.utils.cpp_extension.  Every CUDA
  source is in the one nvcc call, and every launcher has a signature.
- chip_smoke.py exits non-zero, and prints no result, without a CUDA card
  and in a directory that holds nothing else of the repo.
"""

import ast
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (the test files import both packages)
import pytest
import torch

from gpmdm_tpu_torch.ops import _build

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "gpmdm_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "gpmdm_tpu", "optax"), f"{path}: imports {mod}"


def test_kernels_are_built_by_nvcc_for_sm_90a_and_bound_with_ctypes():
    sources = "".join(p.read_text() for p in (ROOT / "gpmdm_tpu_torch").rglob("*.*")
                      if p.suffix in (".py", ".cu", ".cuh"))
    assert "torch/extension.h" not in sources
    assert "cpp_extension" not in sources
    assert "-gencode=arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert _build.build_dir().parent == ROOT / "build" / "torch_kernels"
    assert len(_build.build_dir().name) == 64
    assert "build/" in (ROOT / ".gitignore").read_text().split()
    for name, (_, argtypes) in _build._SIGNATURES.items():
        assert all(t in (_build._P, _build._I) for t in argtypes), name


@pytest.mark.parametrize("source", sorted((ROOT / "gpmdm_tpu_torch" / "ops" / "csrc").glob("*.cu")),
                         ids=lambda p: p.name)
def test_every_cuda_source_is_in_the_one_nvcc_call_with_its_launchers_bound(source):
    """Each .cu is built by the single nvcc call, and every function of its
    extern "C" block has a ctypes signature."""
    assert source in _build.SOURCES
    text = source.read_text()
    block = text[text.index('extern "C" {'):]
    names = re.findall(r"^(?:int|size_t|long long)\s+(\w+)\(", block, flags=re.M)
    assert names, f"{source.name}: no extern C launcher"
    for name in names:
        assert name in _build._SIGNATURES, f"{source.name}: {name} has no ctypes signature"


def test_build_without_nvcc_raises_and_leaves_no_file(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "torch_kernels")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()
    assert not (tmp_path / "torch_kernels").exists()


def _run_smoke(cwd: Path):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True,
                          text=True, timeout=120)


def _prints_result(stdout: str) -> bool:
    for line in stdout.splitlines():
        try:
            if json.loads(line).get("ok"):
                return True
        except (ValueError, AttributeError):
            pass
    return False


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    proc = _run_smoke(ROOT)
    assert proc.returncode != 0
    assert not _prints_result(proc.stdout)
    assert "cuda" in proc.stderr.lower()


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_smoke(tmp_path)
    assert proc.returncode != 0
    assert not _prints_result(proc.stdout)
