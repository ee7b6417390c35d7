"""The port's notebooks (``gpmdm_tpu_torch/notebooks/``): the JAX package's
six under the same names, with as many code cells each, committed without
outputs; every code cell compiles, every ``from X import Y`` names a real
symbol, and the path cell finds the repo root from the notebook's own
folder and takes the device from the platform pin.
"""

import json
import re
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
NB_DIR = REPO / "gpmdm_tpu_torch" / "notebooks"
JAX_NB_DIR = REPO / "notebooks"
NAMES = sorted(p.name for p in JAX_NB_DIR.glob("*.ipynb"))


def code_cells(path):
    nb = json.loads(path.read_text())
    assert nb["nbformat"] == 4
    return [c for c in nb["cells"] if c["cell_type"] == "code"]


def test_the_six_notebooks_are_ported():
    assert len(NAMES) == 6
    assert sorted(p.name for p in NB_DIR.glob("*.ipynb")) == NAMES


@pytest.mark.parametrize("name", NAMES)
def test_notebook_cells_mirror_the_jax_twin_and_compile(name):
    cells = code_cells(NB_DIR / name)
    assert len(cells) == len(code_cells(JAX_NB_DIR / name))
    for i, cell in enumerate(cells):
        assert cell["outputs"] == [] and cell["execution_count"] is None, f"{name}:{i}"
        compile("".join(cell["source"]), f"{name}:cell{i}", "exec")


@pytest.mark.parametrize("name", NAMES)
def test_notebook_imports_resolve_in_the_port(name):
    """Every ``from X import Y`` names a real symbol, and every module of
    this repo that a notebook imports is the port's."""
    import importlib

    src = "\n".join("".join(c["source"]) for c in code_cells(NB_DIR / name))
    found = re.findall(r"^from ([\w.]+) import ([\w, ]+)$", src, re.M)
    assert any(mod.startswith("gpmdm_tpu_torch") for mod, _ in found)
    for mod_name, names in found:
        assert mod_name.split(".")[0] not in ("gpmdm_tpu", "examples"), mod_name
        mod = importlib.import_module(mod_name)
        for sym in (s.strip() for s in names.split(",")):
            assert hasattr(mod, sym), f"{name}: {mod_name}.{sym} missing"


@pytest.mark.parametrize("name", NAMES)
def test_path_cell_finds_the_root_from_the_notebook_folder(name, tmp_path, monkeypatch):
    """Run from ``<root>/gpmdm_tpu_torch/notebooks`` of a stand-in tree, the
    path cell sets ROOT to that root, makes its models/ folder and pins the
    CPU under GPMDM_TPU_PLATFORM=cpu (the card otherwise)."""
    nb_dir = tmp_path / "gpmdm_tpu_torch" / "notebooks"
    nb_dir.mkdir(parents=True)
    (tmp_path / "gpmdm_tpu_torch" / "__init__.py").write_text("")
    monkeypatch.chdir(nb_dir)
    monkeypatch.setattr(sys, "path", list(sys.path))
    cell = "".join(code_cells(NB_DIR / name)[0]["source"])
    for pin, device in (("cpu", "cpu"), ("gpu", "cuda"), (None, "cuda")):
        if pin:
            monkeypatch.setenv("GPMDM_TPU_PLATFORM", pin)
        else:
            monkeypatch.delenv("GPMDM_TPU_PLATFORM", raising=False)
        ns = {}
        exec(compile(cell, f"{name}:cell1", "exec"), ns)
        assert ns["ROOT"] == tmp_path and ns["DEVICE"] == device
        assert ns["MODELS_DIR"] == tmp_path / "models" and ns["MODELS_DIR"].is_dir()
