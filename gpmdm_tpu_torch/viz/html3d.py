"""Interactive 3D latent-space plot as a self-contained HTML file.

Counterpart of the reference's plotly 3D scatters (load_gpmdm.ipynb cell 2,
view_gpmdm_pf.ipynb cell 7).  plotly is not available in every deployment
(and is not a dependency here), so this writes a zero-dependency HTML file:
the points are embedded as JSON and a ~100-line vanilla-JS canvas renderer
provides the same interactions — mouse-drag rotation, wheel zoom, per-class
colors, an optional trajectory polyline.  Open in any browser; no network
access needed.

The JAX package's ``gpmdm_tpu/viz/html3d.py`` for the port: the latent
matrix is read to the host once, here, and the file is the same byte for
byte.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from .latent import host

_PALETTE = [
    "#4269d0", "#efb118", "#ff725c", "#6cc5b0", "#3ca951",
    "#ff8ab7", "#a463f2", "#97bbf5",
]

_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title>
<style>
 body {{ margin:0; background:#111; color:#ddd; font:13px sans-serif; }}
 #hud {{ position:fixed; top:8px; left:10px; }}
 .sw {{ display:inline-block; width:10px; height:10px; margin:0 4px 0 10px; }}
 canvas {{ display:block; cursor:grab; }}
</style></head><body>
<div id="hud">{title} &mdash; drag to rotate, wheel to zoom{legend}</div>
<canvas id="c"></canvas>
<script>
const GROUPS = {groups_json};
const TRAJ = {traj_json};
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
let rx = 0.4, ry = -0.6, zoom = 1.0, drag = null;
function resize() {{ cv.width = innerWidth; cv.height = innerHeight; draw(); }}
addEventListener('resize', resize);
cv.addEventListener('mousedown', e => drag = [e.clientX, e.clientY]);
addEventListener('mouseup', () => drag = null);
addEventListener('mousemove', e => {{
  if (!drag) return;
  ry += (e.clientX - drag[0]) * 0.008; rx += (e.clientY - drag[1]) * 0.008;
  drag = [e.clientX, e.clientY]; draw();
}});
cv.addEventListener('wheel', e => {{
  e.preventDefault(); zoom *= Math.exp(-e.deltaY * 0.001); draw();
}}, {{passive: false}});
function project(p) {{
  const [x, y, z] = p;
  const cx = Math.cos(rx), sx = Math.sin(rx), cy = Math.cos(ry), sy = Math.sin(ry);
  const x1 = cy * x + sy * z, z1 = -sy * x + cy * z;
  const y1 = cx * y - sx * z1, z2 = sx * y + cx * z1;
  const s = Math.min(cv.width, cv.height) * 0.35 * zoom;
  const persp = 3.0 / (3.0 + z2);
  return [cv.width / 2 + x1 * s * persp, cv.height / 2 - y1 * s * persp, z2];
}}
function draw() {{
  ctx.fillStyle = '#111'; ctx.fillRect(0, 0, cv.width, cv.height);
  const dots = [];
  GROUPS.forEach(g => g.pts.forEach(p => {{
    const [px, py, pz] = project(p); dots.push([pz, px, py, g.color]);
  }}));
  dots.sort((a, b) => b[0] - a[0]);
  dots.forEach(([pz, px, py, color]) => {{
    ctx.fillStyle = color; ctx.globalAlpha = 0.9;
    ctx.beginPath(); ctx.arc(px, py, Math.max(1.5, 3 - pz), 0, 6.283); ctx.fill();
  }});
  if (TRAJ.length > 1) {{
    ctx.globalAlpha = 1.0; ctx.strokeStyle = '#fff'; ctx.lineWidth = 1.5;
    ctx.beginPath();
    TRAJ.forEach((p, i) => {{
      const [px, py] = project(p);
      i ? ctx.lineTo(px, py) : ctx.moveTo(px, py);
    }});
    ctx.stroke();
  }}
}}
resize();
</script></body></html>
"""


def write_latent_html(
    model,
    path,
    class_names: Optional[Sequence[str]] = None,
    trajectory: Optional[np.ndarray] = None,
    title: str = "GPMDM latent space",
) -> Path:
    """Write an interactive 3D scatter of the per-class latent embeddings
    (plus an optional PF state-mean trajectory) to a standalone HTML file.

    Returns the written path.
    """
    Xall = host(model.params.X).astype(float)
    scale = np.abs(Xall).max() or 1.0

    groups = []
    legend = []
    for c in range(model.n_classes):
        Xc = host(model.get_X_for_class(c)).astype(float)
        # pad to 3 columns, normalize by the GLOBAL scale so classes stay
        # mutually comparable
        Xc3 = np.concatenate(
            [Xc, np.zeros((len(Xc), max(0, 3 - Xc.shape[1])))], axis=1
        )[:, :3] / scale
        color = _PALETTE[c % len(_PALETTE)]
        name = class_names[c] if class_names else f"class {c}"
        groups.append({"name": name, "color": color, "pts": Xc3.round(5).tolist()})
        legend.append(
            f'<span class="sw" style="background:{color}"></span>{name}'
        )

    traj = []
    if trajectory is not None:
        T = np.asarray(trajectory, dtype=float)
        T = np.concatenate([T, np.zeros((len(T), max(0, 3 - T.shape[1])))], axis=1)
        traj = (T[:, :3] / scale).round(5).tolist()

    html = _TEMPLATE.format(
        title=title,
        legend="".join(legend),
        groups_json=json.dumps(groups),
        traj_json=json.dumps(traj),
    )
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(html)
    return path
