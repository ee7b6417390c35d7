"""Visualization: skeleton drawing, animation viewers, latent-space plots.

The JAX package's ``gpmdm_tpu.viz`` for the port: matplotlib, pygame and
OpenGL are imported inside the functions that draw, and the port's models
are read to the host only at the plotting call.
"""

from .latent import plot_latent_space, plot_loss_history, plot_pf_trajectory
from .mpl_viewer import MPLViewer
from .skeleton_plot import draw_positions, draw_skeleton_frame

__all__ = [
    "MPLViewer",
    "draw_positions",
    "draw_skeleton_frame",
    "plot_latent_space",
    "plot_loss_history",
    "plot_pf_trajectory",
]
