"""One run of one cell: the cell's files found by name, set-up, warm-up,
the measured window, the traced stretch (``--trace 1``), and the check.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric is a file of its own, found by the names in
``BENCHMARK.json``: ``configs/<config>.json`` (sizes, asset, stream shape,
the reference ``reference/<name>.py`` that follows it),
``traffic/<traffic>.json`` (a mix: its mode and the mode's parameters),
``traffic/<mode>.py`` (the loop that drives the program),
``work/<family>_<kind>.py`` (the model FLOPs and kernel work of a step),
``workloads/<cell>.json`` (the limits of the cell's check) and
``metrics/<metric>.py`` (a reader of the traced run's summary).

A configuration's ``family`` names the posterior its cells deploy, which
the reference builds again and the program must deploy
(``bank.setup`` refuses any other):

- ``"exact"``: an exact ``GPMDM``'s own posterior;
- ``"sparse"``: a ``SparseGPMDM``'s own SGPR posterior, of ``My`` and
  ``Mx`` inducing inputs;
- ``"sparsified"``: an exact model served by a persisted post-hoc SGPR
  distillation that its ``deploy_recommendation`` names: ``My``, ``Mx``
  (each class's, as the entry holds it) and ``method`` (``"kmeans"`` or
  ``"stride"``);
- ``"compressed"``: an exact model served by a persisted compressed
  posterior: ``rank_y`` and ``rank_x`` (the largest class's), as the
  entry holds them.
"""

from __future__ import annotations

import gc
import hashlib
import importlib.util
import json
import math
from pathlib import Path

import torch

from . import check, system, traffic, yardstick
from .reference import gp as ref_gp

HERE = Path(__file__).resolve().parent
REPO = HERE.parent


def load_spec() -> dict:
    return json.loads((REPO / "BENCHMARK.json").read_text())


def cell_entry(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def load_json(kind: str, name: str) -> dict:
    return json.loads((HERE / kind / f"{name}.json").read_text())


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def sha256(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 22), b""):
            h.update(block)
    return h.hexdigest()


def load_config(name: str) -> tuple[dict, dict, Path]:
    """The configuration, its asset's path, and the asset read as the
    reference reads it; the asset must be the one the configuration
    pins, with the sizes it states."""
    cfg = load_json("configs", name)
    path = REPO / cfg["asset"]
    if sha256(path) != cfg["asset_sha256"]:
        raise RuntimeError(f"{cfg['asset']} is not the asset that {name} pins")
    asset = ref_gp.load_asset(path)
    mc = asset["cfg"]
    for key in ("D", "d", "n_classes", "dyn_back_step", "dyn_target", "dtype"):
        if mc[key] != cfg[key]:
            raise RuntimeError(f"{name}: the asset's {key} is {mc[key]!r}, not {cfg[key]!r}")
    offs = ref_gp.class_row_offsets(asset)
    if int(offs[-1]) != cfg["Ny"]:
        raise RuntimeError(f"{name}: the asset has Ny = {int(offs[-1])}, not {cfg['Ny']}")
    check_deployment(cfg, asset)
    return cfg, asset, path


def check_deployment(cfg: dict, asset: dict) -> None:
    """Raises unless the asset deploys the posterior that the
    configuration's ``family`` states (module docstring): the model's
    class, the persisted entry, and no deployment recommendation that
    names another."""
    name, family = cfg["name"], cfg["family"]
    meta = asset["meta"]
    rec = meta.get("deploy_recommendation") or {}
    want = "SparseGPMDM" if family == "sparse" else "GPMDM"
    if meta["model_class"] != want:
        raise RuntimeError(f"{name}: family {family!r} needs a {want}, the asset holds a "
                           f"{meta['model_class']}")
    if family == "sparse":
        p = asset["params"]
        if p["Zy"].shape[0] != cfg["My"] or p["Zx"].shape[1] != cfg["Mx"]:
            raise RuntimeError(f"{name}: the asset's inducing sets are not My, Mx as stated")
        return
    if family == "sparsified":
        key = ref_gp.sparsified_entry(asset, cfg)["key"]
        named = (rec.get("M"), rec.get("Mx"), rec.get("method", "stride"))
        if rec.get("family") != "sparsified" or named != key:
            raise RuntimeError(f"{name}: the asset's deployment recommendation {rec or None} "
                               f"does not name the distillation {key}")
        return
    if family == "compressed":
        key = ref_gp.compressed_entry(asset, cfg)["key"]
        if rec and (rec.get("family") != "compressed"
                    or (rec.get("rank_y"), rec.get("rank_x")) != key[:2]):
            raise RuntimeError(f"{name}: the asset's deployment recommendation {rec} "
                               f"overrides the compressed posterior {key}")
        return
    if family != "exact":
        raise RuntimeError(f"{name}: unknown family {family!r}")
    if rec and rec.get("family") != "exact":
        raise RuntimeError(f"{name}: the asset's deployment recommendation {rec} is not exact")


def load_module(kind: str, name: str):
    """The module ``perfbench/<kind>/<name>.py``, found by name."""
    spec = importlib.util.spec_from_file_location(
        f"perfbench_{kind}_" + name.replace(".", "_"), HERE / kind / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_cell(cell_name: str, seed: int, seconds: float, trace_on: bool, device, t0: float,
             overrides: dict | None = None, wrap=None, spec: dict | None = None) -> dict:
    """One run; returns the fields of the result line.  The mix's ``mode``
    is the file ``traffic/<mode>.py`` whose ``run`` drives the program.
    ``overrides`` replaces traffic parameters (tests run small sizes on the
    CPU); ``wrap(kind, fn)`` replaces the program's bank initialisation,
    step or scan (``kind`` 'init', 'step' or 'scan'), for the control and
    the faults (``faults.py``)."""
    spec = spec or load_spec()
    cell = cell_entry(spec, cell_name)
    cfg, asset, path = load_config(cell["config"])
    mix = {**traffic.load_mix(cell["traffic"]), **(overrides or {})}
    limits = load_json("workloads", cell_name)["limits"]
    mode = load_module("traffic", mix["mode"])
    reference = importlib.import_module(f"perfbench.reference.{cfg['reference']}")
    wrap = wrap or (lambda kind, fn: fn)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    on_card = torch.device(device).type == "cuda"
    model = system.load_model(path, device)
    # what set-up made stays: the collector need not walk it again in the
    # window
    gc.collect()
    gc.freeze()
    out = mode.run(model, cfg, asset, mix, seed, seconds, trace_on, device, t0, wrap, reference)
    out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device) if on_card else 0
    # the program's state goes before the reference runs; what the check
    # compares (the recorded states, readouts and draws) stays
    held = out.pop("held")
    del model
    gc.unfreeze()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    numbers = held["check"]()
    ok, checks = check.verdict(numbers, limits)
    out.update(correct=ok, checks=checks, numbers=numbers)
    if trace_on:
        w = load_module("work", f"{cfg['family']}_{mode.WORK}")
        summary = {"kind": mode.WORK, "timed": out["timed"], "profile": out["profile"],
                   "model_flops_per_step": w.model_flops(cfg, mix, asset),
                   "work": w.kernel_work(cfg, mix) if hasattr(w, "kernel_work") else {},
                   "peaks": yardstick.PEAKS}
        metrics = {}
        for m in spec["per_layer"]:
            if applies(m, cell_name) and _reports(spec, m, cell_name):
                v = load_module("metrics", m["name"]).read(summary)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        out["metrics"] = metrics
    else:
        out["metrics"] = {m["name"]: {"value": out["e2e"][m["name"]], "unit": m["unit"]}
                          for m in spec["end_to_end"] if applies(m, cell_name)}
    return out


def _reports(spec: dict, metric: dict, cell: str) -> bool:
    moves = next(m for m in spec["end_to_end"] if m["name"] == metric["moves"])
    return applies(moves, cell)


def result_line(out: dict, device, count: int, trace_on: bool) -> dict:
    """The last line of a run: ``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device`` (with ``busy_s`` and ``window_s`` when traced),
    ``breakdown`` when traced, and last ``checks``, each number that
    decided ``correct`` beside its limit."""
    dev = {**device_info(device, count), "memory_peak_bytes": out["memory_peak_bytes"]}
    line = {"correct": out["correct"], "attempted": out["attempted"], "failed": out["failed"],
            "metrics": out["metrics"], "device": dev}
    if trace_on:
        prof = out["profile"]
        dev.update(busy_s=prof["busy_s"], window_s=prof["window_s"])
        line["breakdown"] = prof["breakdown"]
    line["checks"] = {k: {"value": nan_to_none(c["value"]), "limit": c["limit"]}
                      for k, c in out["checks"].items()}
    return line


def device_info(device, count: int) -> dict:
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count}


def nan_to_none(v):
    return None if isinstance(v, float) and not math.isfinite(v) else v


def check_reference_imports() -> list:
    """Modules that a file of ``reference/`` imports and may not: JAX, the
    JAX package or the program."""
    import ast

    banned = {"jax", "jaxlib", "flax", "gpmdm_tpu", "gpmdm_tpu_torch"}
    found = []
    for src in sorted((HERE / "reference").glob("*.py")):
        for node in ast.walk(ast.parse(src.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                names = [node.module]
            found += [f"{src.name}: {n}" for n in names if n.split(".")[0] in banned]
    return found


def forbidden_modules(modules) -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    banned = {"jax", "jaxlib", "flax", "gpmdm_tpu"}
    return sorted({m for m in modules if m.split(".")[0] in banned})
