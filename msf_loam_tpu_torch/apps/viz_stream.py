"""Live visualization stream: the rviz-topic analog for headless runs.

The port's copy of the JAX package's ``apps/viz_stream.py`` (the same
``state.json`` and viewer from the same pipeline state). The reference publishes ~12 live topics (registered clouds, maps, paths —
``laser_mapping.cc:71-83``) consumed by rviz. Here the engine periodically
publishes its state to ``<dir>/state.json`` (atomic rename, so readers
never see a torn write) and a self-contained ``<dir>/viz_live.html``
viewer polls it and re-renders — trajectory plus an incrementally-sampled
map cloud. Serve the directory (``python -m http.server -d <dir>``) and
open ``viz_live.html`` while the run is in flight.

Map sampling: instead of copying the full voxel slab tensors off the card
every period (tens of MB), only the first ``per_slab`` points of every
slab are read on the host: a uniform spatial subsample by construction
(slab order is insertion order within a cell).
"""

from __future__ import annotations

import json
import os
from typing import List

import numpy as np

_VIEWER = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>msf_loam_tpu live</title>
<style>
 body { margin:0; background:#111; color:#ccc; font:13px monospace; }
 #hud { position:fixed; top:8px; left:8px; }
 canvas { display:block; }
</style></head>
<body>
<div id="hud">msf_loam_tpu live &mdash; drag: orbit &middot; wheel: zoom
 &middot; shift-drag: pan<br><span id="meta">waiting for state.json
 &hellip;</span></div>
<canvas id="c"></canvas>
<script>
let MAP = [], TRAJ = [], FRAME = -1;
const cv = document.getElementById('c');
const ctx = cv.getContext('2d');
let W, H; const resize = () => { W = cv.width = innerWidth;
  H = cv.height = innerHeight; draw(); };
let yaw = 0.7, pitch = 0.5, dist = 60, cx = 0, cy = 0, cz = 0, follow = true;
let drag = null;
cv.onmousedown = e => drag = [e.clientX, e.clientY, e.shiftKey];
onmouseup = () => drag = null;
onmousemove = e => {
  if (!drag) return;
  follow = false;
  const dx = e.clientX - drag[0], dy = e.clientY - drag[1];
  if (drag[2]) { cx -= dx * dist / 500 * Math.cos(yaw);
    cy -= dx * dist / 500 * Math.sin(yaw); cz += dy * dist / 500; }
  else { yaw += dx * 0.01; pitch = Math.max(-1.5, Math.min(1.5,
    pitch + dy * 0.01)); }
  drag = [e.clientX, e.clientY, drag[2]]; draw();
};
onwheel = e => { dist *= Math.exp(e.deltaY * 0.001); draw(); };
function project(x, y, z) {
  x -= cx; y -= cy; z -= cz;
  const cyaw = Math.cos(yaw), syaw = Math.sin(yaw);
  const cp = Math.cos(pitch), sp = Math.sin(pitch);
  let u = cyaw * x + syaw * y, v = -syaw * x + cyaw * y;
  let w2 = cp * z - sp * u; u = sp * z + cp * u;
  const d = u + dist;
  if (d < 0.5) return null;
  return [W / 2 + v / d * H, H / 2 - w2 / d * H, d];
}
function draw() {
  ctx.fillStyle = '#111'; ctx.fillRect(0, 0, W, H);
  for (let i = 0; i < MAP.length; i += 3) {
    const p = project(MAP[i], MAP[i+1], MAP[i+2]);
    if (!p) continue;
    const shade = Math.max(40, 230 - p[2] * 2) | 0;
    ctx.fillStyle = `rgb(${shade*0.5|0},${shade*0.75|0},${shade})`;
    ctx.fillRect(p[0], p[1], 2, 2);
  }
  ctx.strokeStyle = '#ff5050'; ctx.lineWidth = 2; ctx.beginPath();
  let started = false;
  for (let i = 0; i < TRAJ.length; i += 3) {
    const p = project(TRAJ[i], TRAJ[i+1], TRAJ[i+2]);
    if (!p) { started = false; continue; }
    if (!started) { ctx.moveTo(p[0], p[1]); started = true; }
    else ctx.lineTo(p[0], p[1]);
  }
  ctx.stroke();
  const n = TRAJ.length;
  if (n) {
    const p = project(TRAJ[n-3], TRAJ[n-2], TRAJ[n-1]);
    if (p) { ctx.fillStyle = '#ffd050';
      ctx.beginPath(); ctx.arc(p[0], p[1], 5, 0, 7); ctx.fill(); }
  }
}
async function poll() {
  try {
    const r = await fetch('state.json', {cache: 'no-store'});
    if (r.ok) {
      const s = await r.json();
      if (s.frame !== FRAME) {
        FRAME = s.frame; MAP = s.map; TRAJ = s.traj;
        if (follow && TRAJ.length) { cx = TRAJ[TRAJ.length-3];
          cy = TRAJ[TRAJ.length-2]; cz = TRAJ[TRAJ.length-1]; }
        document.getElementById('meta').textContent =
          `frame ${s.frame} | ${TRAJ.length/3} poses | ` +
          `${MAP.length/3} map pts${s.done ? ' | DONE' : ''}`;
        draw();
      }
    }
  } catch (e) {}
  setTimeout(poll, 700);
}
resize(); onresize = resize; poll();
</script></body></html>
"""


class VizStreamWriter:
    """Publishes trajectory + sampled map state for the polling viewer."""

    def __init__(self, out_dir: str, period: int = 20, per_slab: int = 4,
                 max_map_points: int = 60000):
        self.dir = out_dir
        self.period = max(1, period)
        self.per_slab = per_slab
        self.max_map_points = max_map_points
        self._traj: List[np.ndarray] = []
        self._n = 0
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "viz_live.html"), "w") as f:
            f.write(_VIEWER)

    def _sample_map(self, pipe) -> np.ndarray:
        m = getattr(pipe, "surf_map", None)
        if m is None:
            return np.zeros((0, 3), np.float32)
        k = self.per_slab
        pts = m.points[:, :k, :].reshape(-1, 3).cpu().numpy()
        occ = (np.arange(k)[None, :]
               < m.count.cpu().numpy()[:, None]).reshape(-1)
        pts = pts[occ]
        if len(pts) > self.max_map_points:
            pts = pts[np.random.default_rng(0).choice(
                len(pts), self.max_map_points, replace=False)]
        return pts

    def add_frame(self, pipe, done: bool = False) -> None:
        """Record the latest pose; publish every ``period`` frames."""
        if pipe.results:
            self._traj.append(pipe.results[-1].map_pose.t.cpu().numpy())
        self._n += 1
        if self._n % self.period == 0 or done:
            self.publish(pipe, done=done)

    def publish(self, pipe, done: bool = False) -> None:
        pts = self._sample_map(pipe)
        traj = (np.stack(self._traj) if self._traj
                else np.zeros((0, 3), np.float32))
        state = {
            "frame": self._n,
            "done": bool(done),
            "traj": np.round(traj, 3).reshape(-1).tolist(),
            "map": np.round(pts, 3).reshape(-1).tolist(),
        }
        tmp = os.path.join(self.dir, ".state.json.tmp")
        with open(tmp, "w") as f:
            json.dump(state, f)
        os.replace(tmp, os.path.join(self.dir, "state.json"))
