"""Standalone HTML replay viewer for particle series.

A copy of ``python_fluid_simulation_tpu.utils.viewer`` (it needs only
numpy).  Reference counterpart: the k3d point-cloud playback notebook cell
(`3D_viscous_fluid_sim.ipynb` cell 14 :4694-4741).  k3d requires a live
notebook; this writes a single self-contained HTML file (embedded data +
a tiny canvas renderer, no external dependencies) that any browser can
open — the production artifact path.
"""

from __future__ import annotations

import base64
import json
from typing import Dict

import numpy as np

_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>fluid replay</title>
<style>
 body { margin:0; background:#111; color:#ddd; font:13px sans-serif; }
 #hud { position:fixed; top:8px; left:8px; }
 canvas { display:block; }
 input[type=range] { width: 340px; vertical-align: middle; }
 button { margin-right: 8px; }
</style></head>
<body>
<div id="hud">
 <button id="play">play</button>
 <input id="frame" type="range" min="0" value="0" step="1">
 <span id="label"></span>
 <div>drag to rotate &middot; wheel to zoom</div>
</div>
<canvas id="c"></canvas>
<script>
const META = __META__;
const RAW = Uint8Array.from(atob("__DATA__"), c => c.charCodeAt(0));
const F32 = new Float32Array(RAW.buffer);
const NF = META.times.length, NP = META.num_points;
const NE = META.solid_edges || 0;
function framePos(f) { return F32.subarray(f*NP*3, (f+1)*NP*3); }
function solidEdges() { return F32.subarray(NF*NP*3, NF*NP*3 + NE*6); }
const cv = document.getElementById("c"), ctx = cv.getContext("2d");
let W, H; function resize(){ W=cv.width=innerWidth; H=cv.height=innerHeight; }
resize(); addEventListener("resize", resize);
let rotY = 0.6, rotX = 0.35, zoom = 1.0, f = 0, playing = false;
const slider = document.getElementById("frame"); slider.max = NF-1;
const label = document.getElementById("label");
cv.onmousedown = e => { let px=e.clientX, py=e.clientY;
  const mv = ev => { rotY += (ev.clientX-px)*0.008; rotX += (ev.clientY-py)*0.008; px=ev.clientX; py=ev.clientY; draw(); };
  const up = () => { removeEventListener("mousemove", mv); removeEventListener("mouseup", up); };
  addEventListener("mousemove", mv); addEventListener("mouseup", up); };
addEventListener("wheel", e => { zoom *= e.deltaY < 0 ? 1.1 : 0.9; draw(); });
document.getElementById("play").onclick = () => { playing = !playing; };
slider.oninput = () => { f = +slider.value; draw(); };
const C = META.center, S = META.scale;
function draw(){
  ctx.fillStyle = "#111"; ctx.fillRect(0,0,W,H);
  const p = framePos(f), s = Math.min(W,H)*0.42*zoom/S;
  const cy=Math.cos(rotY), sy=Math.sin(rotY), cx=Math.cos(rotX), sx=Math.sin(rotX);
  function proj(x, z, y){
    x -= C[0]; z -= C[1]; y -= C[2];
    const x1 = x*cy + z*sy, z1 = -x*sy + z*cy;
    const y2 = y*cx - z1*sx;
    return [W/2 + x1*s, H/2 - y2*s];
  }
  if (NE) {
    const e = solidEdges();
    ctx.strokeStyle = "#665"; ctx.globalAlpha = 0.35; ctx.beginPath();
    for (let i=0;i<NE;i++){
      const a = proj(e[6*i], e[6*i+1], e[6*i+2]);
      const b = proj(e[6*i+3], e[6*i+4], e[6*i+5]);
      ctx.moveTo(a[0], a[1]); ctx.lineTo(b[0], b[1]);
    }
    ctx.stroke(); ctx.globalAlpha = 1;
  }
  ctx.fillStyle = "#5ad0f0";
  for (let i=0;i<NP;i++){
    const x=p[3*i]-C[0], z=p[3*i+1]-C[1], y=p[3*i+2]-C[2];
    const x1 = x*cy + z*sy, z1 = -x*sy + z*cy;
    const y2 = y*cx - z1*sx, z2 = y*sx + z1*cx;
    const depth = 1.5 + z2/S;
    ctx.globalAlpha = Math.max(0.15, Math.min(1, 1.4 - depth*0.45));
    ctx.fillRect(W/2 + x1*s, H/2 - y2*s, 2, 2);
  }
  ctx.globalAlpha = 1;
  label.textContent = "t = " + META.times[f].toFixed(3) + " s  (frame " + f + "/" + (NF-1) + ")";
  slider.value = f;
}
setInterval(() => { if (playing){ f = (f+1)%NF; draw(); } }, 66);
draw();
</script></body></html>
"""


def export_html_replay(
    series: Dict[float, np.ndarray],
    path: str,
    solid_mesh=None,
    max_solid_edges: int = 20000,
) -> int:
    """Write the particle series (the reference's ps.pickle layout:
    {time: (N,3) float32 in [x,z,y] order}) as a standalone HTML replay.

    ``solid_mesh=(verts (V,3) [x,z,y], tris (T,3))`` additionally embeds
    the solid geometry as a wireframe (one edge per triangle, evenly
    subsampled to ``max_solid_edges``) — the reference shows the solid
    via k3d.marching_cubes next to the points (cell 10 :785-795).

    Returns the number of frames written.  Frames with differing particle
    counts are truncated to the smallest count (the engine keeps N fixed,
    but external series may vary)."""
    times = sorted(series.keys())
    if not times:
        raise ValueError("empty particle series")
    n = min(int(np.asarray(series[t]).shape[0]) for t in times)
    frames = np.stack(
        [np.asarray(series[t], dtype=np.float32)[:n] for t in times]
    )
    if frames.shape[-1] == 2:  # 2D series: embed in the x/y plane
        frames = np.concatenate(
            [frames[..., :1], np.zeros_like(frames[..., :1]), frames[..., 1:]],
            axis=-1,
        )
    center = frames.reshape(-1, 3).mean(axis=0)
    scale = float(
        np.abs(frames.reshape(-1, 3) - center).max() + 1e-6
    )
    blob = frames.tobytes()
    n_edges = 0
    if solid_mesh is not None:
        verts, tris = solid_mesh
        verts = np.asarray(verts, np.float32)
        tris = np.asarray(tris)
        if len(tris):
            stride = max(1, len(tris) // max_solid_edges)
            tt = tris[::stride]
            edges = np.stack(
                [verts[tt[:, 0]], verts[tt[:, 1]]], axis=1
            ).astype(np.float32)  # (E, 2, 3)
            n_edges = int(edges.shape[0])
            blob += edges.tobytes()
    meta = {
        "times": [float(t) for t in times],
        "num_points": int(n),
        "center": [float(c) for c in center],
        "scale": scale,
        "solid_edges": n_edges,
    }
    raw = base64.b64encode(blob).decode("ascii")
    html = _TEMPLATE.replace("__META__", json.dumps(meta)).replace(
        "__DATA__", raw
    )
    with open(path, "w") as fh:
        fh.write(html)
    return len(times)
