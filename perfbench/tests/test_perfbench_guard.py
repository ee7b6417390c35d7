"""The import guard: JAX, jaxlib, flax and the JAX package by whole
top-level name; the port and names that only begin alike pass."""

import shutil
import subprocess
import sys

from perfbench import harness


def test_forbidden_by_whole_top_level_name():
    bad = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "gpmdm_tpu",
           "gpmdm_tpu.ops.kernels"]
    ok = ["gpmdm_tpu_torch", "gpmdm_tpu_torch.ops", "jaxtyping", "flaxen", "numpy", "torch"]
    assert harness.forbidden_modules(bad + ok) == sorted(bad)


def test_reference_imports_nothing_of_the_program(tmp_path, monkeypatch):
    assert harness.check_reference_imports() == []
    shutil.copytree(harness.HERE / "reference", tmp_path / "reference")
    (tmp_path / "reference" / "leak.py").write_text(
        "import numpy\nfrom gpmdm_tpu_torch.models import core\nimport jax.numpy as jnp\n")
    monkeypatch.setattr(harness, "HERE", tmp_path)
    assert harness.check_reference_imports() == ["leak.py: gpmdm_tpu_torch.models",
                                                 "leak.py: jax.numpy"]


def test_the_harness_loads_no_jax():
    """Importing the harness, the program it drives and the reference, in a
    fresh interpreter, loads no forbidden module."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from perfbench import bank, harness, faults, control, system\n"
            "import gpmdm_tpu_torch, gpmdm_tpu_torch.utils.io\n"
            "import gpmdm_tpu_torch.filter.particle_filter\n"
            "print(harness.forbidden_modules(sys.modules))" % str(harness.REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
