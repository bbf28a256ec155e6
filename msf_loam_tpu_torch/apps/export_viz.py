"""Standalone HTML visualization export.

The port's copy of the JAX package's ``apps/export_viz.py`` (the same
HTML from the same files), the rviz replacement (the reference ships an
rviz config with 24 topic panels): renders the saved map cloud +
trajectory into a single self-contained HTML file (inline canvas WebGL-free
point renderer, no network dependencies) for quick inspection anywhere.

Usage:
  python -m msf_loam_tpu_torch.apps.export_viz \
      --trajectory out/trajectory.npz [--map out/msf_loam_cloud.ply] [--output viz.html] [--max_points N]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>msf_loam_tpu viz</title>
<style>
 body {{ margin:0; background:#111; color:#ccc; font:13px monospace; }}
 #hud {{ position:fixed; top:8px; left:8px; }}
 canvas {{ display:block; }}
</style></head>
<body>
<div id="hud">msf_loam_tpu &mdash; drag: orbit &middot; wheel: zoom &middot;
 shift-drag: pan<br>{meta}</div>
<canvas id="c"></canvas>
<script>
const MAP = {map_json};     // [x,y,z] flat
const TRAJ = {traj_json};   // [x,y,z] flat
const cv = document.getElementById('c');
const ctx = cv.getContext('2d');
let W, H; const resize = () => {{ W = cv.width = innerWidth;
  H = cv.height = innerHeight; }}; resize(); onresize = resize;
let yaw = 0.7, pitch = 0.5, dist = 60, cx = 0, cy = 0, cz = 0;
if (TRAJ.length) {{ cx = TRAJ[0]; cy = TRAJ[1]; cz = TRAJ[2]; }}
let drag = null;
cv.onmousedown = e => drag = [e.clientX, e.clientY, e.shiftKey];
onmouseup = () => drag = null;
onmousemove = e => {{
  if (!drag) return;
  const dx = e.clientX - drag[0], dy = e.clientY - drag[1];
  if (drag[2]) {{ cx -= dx * dist / 500 * Math.cos(yaw);
    cy -= dx * dist / 500 * Math.sin(yaw); cz += dy * dist / 500; }}
  else {{ yaw += dx * 0.01; pitch = Math.max(-1.5, Math.min(1.5,
    pitch + dy * 0.01)); }}
  drag = [e.clientX, e.clientY, drag[2]]; draw();
}};
onwheel = e => {{ dist *= Math.exp(e.deltaY * 0.001); draw(); }};
function project(x, y, z) {{
  x -= cx; y -= cy; z -= cz;
  const cyaw = Math.cos(yaw), syaw = Math.sin(yaw);
  const cp = Math.cos(pitch), sp = Math.sin(pitch);
  let u = cyaw * x + syaw * y, v = -syaw * x + cyaw * y;
  let w2 = cp * z - sp * u; u = sp * z + cp * u;
  const d = u + dist;
  if (d < 0.5) return null;
  return [W / 2 + v / d * H, H / 2 - w2 / d * H, d];
}}
function draw() {{
  ctx.fillStyle = '#111'; ctx.fillRect(0, 0, W, H);
  for (let i = 0; i < MAP.length; i += 3) {{
    const p = project(MAP[i], MAP[i+1], MAP[i+2]);
    if (!p) continue;
    const shade = Math.max(40, 230 - p[2] * 2) | 0;
    ctx.fillStyle = `rgb(${{shade*0.5|0}},${{shade*0.75|0}},${{shade}})`;
    ctx.fillRect(p[0], p[1], 2, 2);
  }}
  ctx.strokeStyle = '#ff5050'; ctx.lineWidth = 2; ctx.beginPath();
  let started = false;
  for (let i = 0; i < TRAJ.length; i += 3) {{
    const p = project(TRAJ[i], TRAJ[i+1], TRAJ[i+2]);
    if (!p) {{ started = false; continue; }}
    if (!started) {{ ctx.moveTo(p[0], p[1]); started = true; }}
    else ctx.lineTo(p[0], p[1]);
  }}
  ctx.stroke();
}}
draw();
</script></body></html>
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--trajectory", required=True)
    ap.add_argument("--map")
    ap.add_argument("--output", default="viz.html")
    ap.add_argument("--max_points", type=int, default=60000)
    args = ap.parse_args(argv)

    from msf_loam_tpu_torch.dataio.artifacts import load_ply, load_trajectory

    traj = load_trajectory(args.trajectory)
    traj_t = traj["translation"]
    map_pts = np.zeros((0, 3))
    if args.map:
        map_pts = load_ply(args.map)
        if len(map_pts) > args.max_points:
            sel = np.random.default_rng(0).choice(
                len(map_pts), args.max_points, replace=False)
            map_pts = map_pts[sel]

    html = _TEMPLATE.format(
        meta=f"{len(traj_t)} poses &middot; {len(map_pts)} map points",
        map_json=json.dumps(np.round(map_pts, 3).reshape(-1).tolist()),
        traj_json=json.dumps(np.round(traj_t, 3).reshape(-1).tolist()),
    )
    with open(args.output, "w") as f:
        f.write(html)
    print(json.dumps({"output": args.output, "poses": len(traj_t),
                      "map_points": int(len(map_pts))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
