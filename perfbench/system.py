"""The system under test: ``gpmdm_tpu_torch``, loaded from a configuration's
asset and driven through its own entry points.  Nothing else of the
program is touched: the filter cells call ``pf_init_bank``,
``pf_step_bank`` and ``pf_scan_bank`` on the posterior that
``resolve_posterior(model, 'auto')`` deploys.
"""

from __future__ import annotations

import torch


def load_model(path, device):
    from gpmdm_tpu_torch.utils.io import load_model as _load

    return _load(path, device)


class FilterSystem:
    """A trained model's filter bank: ``init`` (B banks of Pb particles),
    ``step`` (one frame of every bank) and ``scan`` (T frames ahead)."""

    def __init__(self, model, T_matrix, n_particles: int, filter_cfg: dict):
        from gpmdm_tpu_torch.config import PFConfig
        from gpmdm_tpu_torch.filter import particle_filter as pf

        self.pf = pf
        self.model = model
        self.post = pf.resolve_posterior(model, "auto")
        self.pf_cfg = PFConfig(num_particles=n_particles, **filter_cfg)
        self.log_T = torch.log(torch.as_tensor(T_matrix, device=model.device).to(model.dtype))
        self.d, self.D = model.d, model.D
        self.dtype, self.device = model.dtype, model.device

    @property
    def posterior_kind(self) -> str:
        return type(self.post).__name__

    def deployment(self) -> dict:
        """The deployed posterior in a configuration's terms: its
        ``family``, from its type and, for an SGPR posterior, whether it was
        distilled from an exact model; its inducing sets or its ranks."""
        p, kind = self.post, self.posterior_kind
        if kind == "CompressedPosterior":
            return {"family": "compressed", "rank_y": p.rank_y, "rank_x": p.rank_x}
        if kind == "SparsePosterior":
            return {"family": "sparsified" if p.distilled else "sparse",
                    "My": p.Zy.shape[0], "Mx": p.Zx.shape[1]}
        return {"family": "exact" if kind == "Posterior" else kind}

    def noise(self, u_trans, eps, u_res):
        return self.pf.PFNoise(u_trans=u_trans, eps_dyn=eps, u_res=u_res)

    def init(self, n_banks: int, generator: torch.Generator):
        return self.pf.pf_init_bank(self.post, self.model.layout.y_class_offsets, generator,
                                    self.pf_cfg, n_banks)

    def step(self, state, z, noise):
        m = self.model
        return self.pf.pf_step_bank(state, z, self.post, m.params, self.log_T, m.config,
                                    self.pf_cfg, noise=noise)

    def scan(self, state, Z, noise):
        m = self.model
        return self.pf.pf_scan_bank(state, Z, self.post, m.params, self.log_T, m.config,
                                    self.pf_cfg, noise=noise)
