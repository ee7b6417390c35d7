"""Sharded filter banks: data parallelism over independent filters.

Counterpart of ``gpmdm_tpu/parallel/pf_bank.py``.  Each bank is an
independent filter over a shared model posterior, so the bank axis is
sharded over the mesh's ``dp`` axis and the model state is replicated:
every rank holds the posterior and parameters on its own device and scans
its B / |dp| banks through ``particle_filter``'s bank step, on the kernels
that ``pf_cfg.pallas`` picks (K1, K2 and K3 on the card).  The scan makes
no collective; the outputs are gathered once after it, by the ``gather``
flag or by the caller (:func:`gather_outputs`).

Random streams.  The JAX package keys each bank separately, so a sharded
run equals the unsharded one.  The port draws every bank from one
generator (ROADMAP C6); to keep the property, every rank draws each
frame's noise for the whole bank (``particle_filter.draw_noise``, as the
unsharded scan does) from its copy of the same seeded generator and keeps
its own rows; injected ``noise`` is sliced the same way.  Banks past
``n_banks`` are padding: they take no draws (zeros), so the first
``n_banks`` see the draws of an unpadded, unsharded scan of them.
Multinomial resampling draws from the generator inside the step, on the
local banks only: its streams differ from the unsharded scan's.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..config import GPMDMConfig, PFConfig
from ..filter import particle_filter as pf
from ..models import core
from . import collectives as C
from .mesh import axis_size


def _rows(mesh: DeviceMesh, axis: str, B: int) -> slice:
    n = axis_size(mesh, axis)
    if B % n != 0:
        raise ValueError(f"{B} banks over |{axis}| = {n}: pad the bank to a multiple")
    i, b = mesh.get_local_rank(axis), B // n
    return slice(i * b, (i + 1) * b)


def shard_bank_state(states: pf.PFState, mesh: DeviceMesh, axis: str = "dp") -> pf.PFState:
    """This rank's rows of a bank-stacked ``PFState`` (leading bank axis on
    every field, B divisible by |axis|)."""
    rows = _rows(mesh, axis, states.x.shape[0])
    return pf._map(states, lambda a: a[rows])


def gather_outputs(outs: pf.PFOutputs, mesh: DeviceMesh, axis: str = "dp") -> pf.PFOutputs:
    """Every rank's readouts (B_local, T, ...) gathered into the whole
    bank's (B, T, ...), on every rank, in one all-gather of the packed
    fields."""
    Bl, T, Cn = outs.class_probs.shape
    d = outs.state_mean.shape[-1]
    dt = outs.class_probs.dtype
    packed = torch.cat([outs.class_probs, outs.log_likelihood[..., None], outs.state_mean,
                        outs.most_likely_class[..., None].to(dt)], dim=-1)
    full = C.all_gather(packed, mesh.get_group(axis))
    return pf.PFOutputs(class_probs=full[..., :Cn], log_likelihood=full[..., Cn],
                        state_mean=full[..., Cn + 1:Cn + 1 + d],
                        most_likely_class=full[..., -1].to(outs.most_likely_class.dtype))


def _frame_noise(rows: slice, B: int, Pb: int, d: int, like: torch.Tensor,
                 generator: torch.Generator | None, noise: pf.PFNoise | None,
                 n_banks: int | None):
    """Frame t's noise for this rank's rows: sliced from ``noise``, or drawn
    for the whole bank's first ``n_banks`` rows and sliced (zeros past
    them); None without either (the step then raises)."""
    n_banks = B if n_banks is None else n_banks

    def at(t):
        if noise is not None:
            return pf._map(noise, lambda a: a[t][rows])
        if generator is None:
            return None
        full = pf.draw_noise(n_banks, Pb, d, generator, like.dtype, like.device)
        if n_banks < B:
            full = pf._map(full, lambda a: torch.cat(
                [a, a.new_zeros((B - n_banks,) + tuple(a.shape[1:]))]))
        return pf._map(full, lambda a: a[rows])

    return at


def pf_scan_bank_sharded_masked(states: pf.PFState, Z: torch.Tensor, valid: torch.Tensor | None,
                                post, params: core.GPMDMParams, log_T: torch.Tensor,
                                cfg: GPMDMConfig, pf_cfg: PFConfig, mesh: DeviceMesh,
                                axis: str = "dp", generator: torch.Generator | None = None,
                                noise: pf.PFNoise | None = None, n_banks: int | None = None,
                                gather: bool = False):
    """B banks over B padded sequences (the multi-device form of
    ``utils.metrics.evaluate_pf_banked``), the bank axis sharded over
    ``axis``.  ``states`` (B, Pb, ...), ``Z`` (B, T, D) and ``valid`` (B,
    T) are the WHOLE bank, the same on every rank; B must be divisible by
    |axis|.  Randomness: ``noise`` (T, B, ...) when given, else drawn from
    ``generator`` per frame for the whole bank (see the module docstring;
    ``n_banks`` marks the rows past it as padding).  Returns (this rank's
    final states, its readouts (B / |axis|, T, ...)), or with ``gather``
    the whole bank's readouts (one all-gather after the scan)."""
    B, Pb, d = states.x.shape
    rows = _rows(mesh, axis, B)
    frame_noise = _frame_noise(rows, B, Pb, d, states.x, generator, noise, n_banks)
    final, outs = pf.scan_bank_frames(
        shard_bank_state(states, mesh, axis), Z[rows], None if valid is None else valid[rows],
        post, params, log_T, cfg, pf_cfg, frame_noise, generator)
    return final, gather_outputs(outs, mesh, axis) if gather else outs


def pf_scan_bank_sharded(states: pf.PFState, Z: torch.Tensor, post, params: core.GPMDMParams,
                         log_T: torch.Tensor, cfg: GPMDMConfig, pf_cfg: PFConfig,
                         mesh: DeviceMesh, axis: str = "dp",
                         generator: torch.Generator | None = None,
                         noise: pf.PFNoise | None = None, gather: bool = False):
    """B filter banks over (B, T, D) observations, every frame valid, the
    bank axis sharded over ``axis`` and the model state replicated (see
    :func:`pf_scan_bank_sharded_masked`)."""
    return pf_scan_bank_sharded_masked(states, Z, None, post, params, log_T, cfg, pf_cfg, mesh,
                                       axis, generator=generator, noise=noise, gather=gather)
