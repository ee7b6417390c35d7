"""Process groups for the distribution layer, and a launcher of ranks.

Torch is multi-process SPMD: one process per device, where the JAX
package drives all devices from one process.  :func:`init_distributed`
starts this process's rank; :func:`launch` runs a module-level function
on ``world_size`` ranks and returns each rank's result.

- A rank's device is ``cuda:LOCAL_RANK`` (0 without a launcher) and its
  backend NCCL, unless the caller asks for ``device='cpu'``, which runs
  over gloo.  Nothing falls back on its own: without a CUDA card and
  without ``device='cpu'`` the start raises.
- Under ``torchrun --nproc-per-node=N`` (``RANK``, ``WORLD_SIZE`` and
  ``LOCAL_RANK`` set) the group starts from the environment and
  :func:`launch` runs its function in this process, on this rank.
- Otherwise :func:`launch` spawns the ranks, which meet through a
  ``FileStore`` in a temporary directory: no TCP port, no network.  The
  parent holds a wall limit: past it the ranks are killed and
  ``TimeoutError`` is raised; a collective that waits longer than the
  group's timeout raises in its rank.  A spawned rank imports the
  function's module and nothing of its parent's, so rank bodies live in
  modules that import only what the ranks need.
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time
import traceback
from typing import Callable, Optional

import torch
import torch.distributed as dist

#: Default seconds a collective may wait, and a launch may take.
DEFAULT_TIMEOUT_S = 600.0


def _under_launcher() -> bool:
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def rank_device(device: Optional[str] = None) -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` unless ``device`` is
    ``'cpu'``."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run over gloo")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))


def init_distributed(device: Optional[str] = None, *, rank: Optional[int] = None,
                     world_size: Optional[int] = None, store_path: Optional[str] = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Start this process's rank of the default process group and return
    its device: NCCL on ``cuda:LOCAL_RANK``, or gloo when ``device`` is
    ``'cpu'``.  Under a launcher the rank and world come from the
    environment; otherwise from ``rank`` / ``world_size`` (0 and 1 by
    default), meeting through a ``FileStore`` at ``store_path`` (a new
    temporary file by default: enough for a world of one)."""
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    timeout = datetime.timedelta(seconds=timeout_s)
    if _under_launcher():
        dist.init_process_group(backend, timeout=timeout)
    else:
        rank, world_size = rank or 0, world_size or 1
        if store_path is None:
            if world_size != 1:
                raise ValueError("a world of more than one rank needs a shared store_path")
            store_path = os.path.join(tempfile.mkdtemp(prefix="gpmdm_dist_"), "store")
        store = dist.FileStore(store_path, world_size)
        dist.init_process_group(backend, store=store, rank=rank, world_size=world_size,
                                timeout=timeout)
    return dev


def shutdown() -> None:
    """End this process's rank of the default group, if one was started."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _rank_main(fn, args, rank, world_size, device, workdir, timeout_s):
    os.environ["LOCAL_RANK"] = str(rank)  # this rank's card: cuda:rank
    try:
        init_distributed(device, rank=rank, world_size=world_size,
                         store_path=os.path.join(workdir, "store"), timeout_s=timeout_s)
        out = fn(*args)
        with open(os.path.join(workdir, f"result_{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    except BaseException:
        tmp = os.path.join(workdir, f"partial_{rank}.txt")
        with open(tmp, "w") as f:
            f.write(traceback.format_exc())
        os.replace(tmp, os.path.join(workdir, f"error_{rank}.txt"))
        raise SystemExit(1)
    finally:
        shutdown()


def launch(fn: Callable, world_size: int, *args, device: Optional[str] = None,
           timeout_s: float = DEFAULT_TIMEOUT_S) -> list:
    """Run ``fn(*args)`` on ``world_size`` ranks and return the list of
    their results, by rank.  ``fn`` must be a module-level function and
    ``args`` and results picklable.  Each rank has started its process
    group (:func:`init_distributed` with ``device``) before ``fn`` runs and
    ends it after.

    Under a launcher (``torchrun``) ``fn`` runs in this process, on this
    rank, and the results are gathered from every rank; ``world_size``
    must be the launcher's.  Otherwise the ranks are spawned, and the call
    raises ``TimeoutError`` once ``timeout_s`` seconds pass (the ranks are
    killed) or ``RuntimeError`` with a failed rank's traceback."""
    if _under_launcher():
        if int(os.environ["WORLD_SIZE"]) != world_size:
            raise ValueError(f"launch({world_size}) under a launcher of "
                             f"{os.environ['WORLD_SIZE']} ranks")
        started = not dist.is_initialized()
        if started:
            init_distributed(device, timeout_s=timeout_s)
        try:
            results = [None] * world_size
            dist.all_gather_object(results, fn(*args))
            return results
        finally:
            if started:
                shutdown()

    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="gpmdm_launch_") as workdir:
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, args, r, world_size, device, workdir, timeout_s))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        try:
            while True:
                errors = sorted(f for f in os.listdir(workdir) if f.startswith("error_"))
                failed = any(p.exitcode not in (None, 0) for p in procs)
                if (errors or failed or time.monotonic() > deadline
                        or not any(p.is_alive() for p in procs)):
                    break
                time.sleep(0.02)
        finally:
            alive = [p for p in procs if p.is_alive()]
            for p in alive:
                p.kill()
            for p in procs:
                p.join()
        if errors:
            with open(os.path.join(workdir, errors[0])) as f:
                raise RuntimeError(f"rank {errors[0][6:-4]} failed:\n{f.read()}")
        if alive and not failed:
            raise TimeoutError(f"{len(alive)} of {world_size} ranks still running after "
                               f"{timeout_s} s; killed")
        bad = [r for r, p in enumerate(procs) if p not in alive and p.exitcode != 0]
        if bad:
            raise RuntimeError(f"ranks {bad} exited with codes "
                               f"{[procs[r].exitcode for r in bad]}")
        results = []
        for r in range(world_size):
            with open(os.path.join(workdir, f"result_{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
