"""Latent-space visualization for trained GPMDM models.

Library versions of the reference notebooks' plots: per-class latent
embeddings in 2D/3D scatter (train_gpmdm.ipynb cell 6, load_gpmdm.ipynb
cells 1-3) and particle-filter state trajectories over the training manifold
(view_gpmdm_pf.ipynb cell 7).  Matplotlib only (the reference also uses
plotly, which is not a hard dependency here).

The JAX package's ``gpmdm_tpu/viz/latent.py`` for the port's models
(``GPMDM``, ``SparseGPMDM``, ``BCGPMDM``): ``params.X`` and each
``get_X_for_class(c)`` are read to the host once per call, at the plotting
call, wherever the model lives.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def host(a) -> np.ndarray:
    """A tensor on any device (or an array-like) as a numpy array, read once."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def plot_latent_space(
    model,
    ax=None,
    class_names: Optional[Sequence[str]] = None,
    dims: Sequence[int] = (0, 1, 2),
    show: bool = False,
):
    """Scatter the latent matrix X colored by class.

    Uses the first 2 or 3 entries of ``dims`` depending on the model's latent
    dimension.  Returns the axis.
    """
    import matplotlib.pyplot as plt

    d3 = model.params.X.shape[1] >= 3 and len(dims) >= 3
    if ax is None:
        fig = plt.figure()
        ax = fig.add_subplot(projection="3d" if d3 else None)
    for c in range(model.n_classes):
        Xc = host(model.get_X_for_class(c))
        label = class_names[c] if class_names else f"class {c}"
        if d3:
            ax.scatter(Xc[:, dims[0]], Xc[:, dims[1]], Xc[:, dims[2]], s=6, label=label)
        else:
            ax.scatter(Xc[:, dims[0]], Xc[:, dims[1]], s=6, label=label)
    ax.legend()
    ax.set_title("GPMDM latent space")
    if show:
        plt.show()
    return ax


def plot_pf_trajectory(
    model,
    trajectory,
    ax=None,
    dims: Sequence[int] = (0, 1, 2),
    show: bool = False,
):
    """Overlay a particle-filter state-mean trajectory (numpy or a tensor)
    on the latent manifold (reference view_gpmdm_pf.ipynb cells 7-8)."""
    ax = plot_latent_space(model, ax=ax, dims=dims)
    traj = host(trajectory)
    d3 = traj.shape[1] >= 3 and len(dims) >= 3 and hasattr(ax, "plot3D")
    if d3:
        ax.plot(traj[:, dims[0]], traj[:, dims[1]], traj[:, dims[2]], "k-", lw=1.5,
                label="PF state mean")
    else:
        ax.plot(traj[:, dims[0]], traj[:, dims[1]], "k-", lw=1.5, label="PF state mean")
    ax.legend()
    if show:
        import matplotlib.pyplot as plt

        plt.show()
    return ax


def plot_loss_history(losses, ax=None, show: bool = False):
    """Training loss curve (reference train_gpmdm.ipynb cell 5)."""
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots()
    ax.plot(host(losses))
    ax.set_xlabel("Adam step")
    ax.set_ylabel("MAP loss")
    ax.set_yscale("symlog")
    if show:
        plt.show()
    return ax
