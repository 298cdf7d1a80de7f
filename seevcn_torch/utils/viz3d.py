"""Interactive 3D scene viewer as one self-contained HTML file, and a
``.ply`` exporter (port of seevcn_tpu/utils/viz3d.py).

The point cloud and boxes are embedded as base64 Float32 buffers and drawn
with vanilla-JS canvas orbit/zoom/pan controls: open in any browser, no
server, no CDN. ``export_ply`` writes the JAX package's file byte for byte.
"""
from __future__ import annotations

import base64
import json

import numpy as np


def export_ply(path: str, points: np.ndarray, colors: np.ndarray | None = None,
               binary: bool = True):
    """points (N, 3[+]) -> .ply; colors (N, 3) uint8 optional."""
    pts = np.asarray(points, np.float32)[:, :3]
    n = len(pts)
    has_c = colors is not None
    header = ["ply",
              "format binary_little_endian 1.0" if binary else "format ascii 1.0",
              f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    if has_c:
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
    header.append("end_header")
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        if binary:
            if has_c:
                rec = np.zeros(n, dtype=[("xyz", np.float32, 3),
                                         ("rgb", np.uint8, 3)])
                rec["xyz"] = pts
                rec["rgb"] = np.asarray(colors, np.uint8)
                f.write(rec.tobytes())
            else:
                f.write(pts.tobytes())
        else:
            c = np.asarray(colors, np.uint8) if has_c else None
            for i in range(n):
                row = "%g %g %g" % tuple(pts[i])
                if has_c:
                    row += " %d %d %d" % tuple(c[i])
                f.write((row + "\n").encode())


def _box_edges(boxes: np.ndarray) -> np.ndarray:
    """(M, 7) -> (M, 12, 2, 3) wireframe segments (+ heading tick)."""
    if boxes is None or len(boxes) == 0:
        return np.zeros((0, 14, 2, 3), np.float32)
    boxes = np.asarray(boxes, np.float32)
    corners = np.array([[1, 1, 1], [1, -1, 1], [-1, -1, 1], [-1, 1, 1],
                        [1, 1, -1], [1, -1, -1], [-1, -1, -1], [-1, 1, -1]],
                       np.float32) * 0.5
    local = corners[None] * boxes[:, None, 3:6]
    c, s = np.cos(boxes[:, 6]), np.sin(boxes[:, 6])
    rot = np.stack([np.stack([c, -s], 1), np.stack([s, c], 1)], 1)  # (M,2,2)
    xy = np.einsum("mij,mkj->mki", rot, local[..., :2])
    pts = np.concatenate([xy, local[..., 2:]], -1) + boxes[:, None, :3]
    e = [(0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7), (7, 4),
         (0, 4), (1, 5), (2, 6), (3, 7)]
    segs = np.stack([np.stack([pts[:, a], pts[:, b]], 1) for a, b in e], 1)
    # heading tick: front-face center -> outward
    front = (pts[:, 0] + pts[:, 1] + pts[:, 4] + pts[:, 5]) / 4
    ctr = boxes[:, :3]
    tick = np.stack([ctr, front + (front - ctr) * 0.3], 1)[:, None]
    diag = np.stack([pts[:, 0], pts[:, 5]], 1)[:, None]  # X on the front face
    return np.concatenate([segs, tick, diag], 1).astype(np.float32)


_HTML = """<!doctype html><html><head><meta charset="utf-8">
<title>seevcn scene</title><style>
body{margin:0;background:#101014;color:#ccc;font:12px monospace;overflow:hidden}
#hud{position:fixed;top:8px;left:8px;user-select:none}
canvas{display:block}</style></head><body>
<div id="hud">drag: orbit &nbsp; wheel: zoom &nbsp; shift-drag: pan
&nbsp;|&nbsp; <span id="info"></span></div>
<canvas id="c"></canvas>
<script>
const DATA = __DATA__;
function decode(b64){const s=atob(b64);const u=new Uint8Array(s.length);
 for(let i=0;i<s.length;i++)u[i]=s.charCodeAt(i);return new Float32Array(u.buffer);}
const pts = decode(DATA.points);           // xyz interleaved
const segs = DATA.seg_sets.map(g=>({color:g.color,data:decode(g.data)}));
const N = pts.length/3;
document.getElementById('info').textContent = N+' pts, '+DATA.n_boxes+' boxes';
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
let W,H; function resize(){W=cv.width=innerWidth;H=cv.height=innerHeight;}
resize(); addEventListener('resize',()=>{resize();draw();});
let yaw=-0.9, pitch=0.45, dist=DATA.radius*2.2, cx=DATA.center[0],
    cy=DATA.center[1], cz=DATA.center[2];
function proj(x,y,z){
  x-=cx;y-=cy;z-=cz;
  const cyw=Math.cos(yaw),syw=Math.sin(yaw);
  let u=x*cyw+y*syw, v=-x*syw+y*cyw;
  const cp=Math.cos(pitch),sp=Math.sin(pitch);
  let w2=v*cp+z*sp, d=v*sp-z*cp;
  d+=dist;
  if(d<0.1)return null;
  const f=0.9*H/d;
  return [W/2+u*f, H/2-w2*f, d];
}
function draw(){
  ctx.fillStyle='#101014';ctx.fillRect(0,0,W,H);
  const img=ctx.getImageData(0,0,W,H), px=img.data;
  for(let i=0;i<N;i++){
    const p=proj(pts[3*i],pts[3*i+1],pts[3*i+2]); if(!p)continue;
    const x=p[0]|0,y=p[1]|0; if(x<0||y<0||x>=W||y>=H)continue;
    const k=4*(y*W+x);
    const t=Math.max(0,1-p[2]/(dist*2));
    px[k]=120+120*t; px[k+1]=180+60*t; px[k+2]=255; px[k+3]=255;
  }
  ctx.putImageData(img,0,0);
  ctx.lineWidth=1.5;
  for(const g of segs){
    ctx.strokeStyle=g.color; ctx.beginPath();
    for(let i=0;i<g.data.length;i+=6){
      const a=proj(g.data[i],g.data[i+1],g.data[i+2]);
      const b=proj(g.data[i+3],g.data[i+4],g.data[i+5]);
      if(!a||!b)continue;
      ctx.moveTo(a[0],a[1]); ctx.lineTo(b[0],b[1]);
    }
    ctx.stroke();
  }
  // axes
  const o=proj(0,0,0);
  if(o){for(const [dx,dy,dz,col] of [[2,0,0,'#f55'],[0,2,0,'#5f5'],[0,0,2,'#59f']]){
    const a=proj(dx,dy,dz); if(!a)continue;
    ctx.strokeStyle=col;ctx.beginPath();ctx.moveTo(o[0],o[1]);
    ctx.lineTo(a[0],a[1]);ctx.stroke();}}
}
let drag=null;
cv.onmousedown=e=>drag=[e.clientX,e.clientY,e.shiftKey];
onmouseup=()=>drag=null;
onmousemove=e=>{if(!drag)return;
  const dx=e.clientX-drag[0],dy=e.clientY-drag[1];
  if(drag[2]){const s=dist/H;
    const cyw=Math.cos(yaw),syw=Math.sin(yaw);
    cx-=(dx*cyw)*s; cy-=(dx*syw)*s; cz+=dy*s;}
  else {yaw+=dx*0.008; pitch=Math.max(-1.5,Math.min(1.5,pitch+dy*0.008));}
  drag=[e.clientX,e.clientY,drag[2]]; draw();};
cv.onwheel=e=>{dist*=Math.exp(e.deltaY*0.001);draw();e.preventDefault();};
draw();
</script></body></html>
"""


def _b64(a: np.ndarray) -> str:
    return base64.b64encode(np.ascontiguousarray(a, np.float32).tobytes()).decode()


def save_scene_html(path: str, points, gt_boxes=None, ref_boxes=None,
                    ref_scores=None, max_points: int = 200_000):
    """Write a standalone interactive scene (reference
    open3d_vis_utils.draw_scenes analog). gt boxes cyan-green, predictions
    red (brighter with score)."""
    pts = np.asarray(points, np.float32)[:, :3]
    if len(pts) > max_points:
        sel = np.random.RandomState(0).choice(len(pts), max_points,
                                              replace=False)
        pts = pts[sel]
    seg_sets = []
    n_boxes = 0
    if gt_boxes is not None and len(gt_boxes):
        seg_sets.append({"color": "#00d080",
                         "data": _b64(_box_edges(gt_boxes).reshape(-1))})
        n_boxes += len(gt_boxes)
    if ref_boxes is not None and len(ref_boxes):
        seg_sets.append({"color": "#ff5050",
                         "data": _b64(_box_edges(ref_boxes).reshape(-1))})
        n_boxes += len(ref_boxes)
    center = pts.mean(0) if len(pts) else np.zeros(3)
    radius = float(np.percentile(np.linalg.norm(pts - center, axis=1), 90)) \
        if len(pts) else 10.0
    data = {"points": _b64(pts.reshape(-1)), "seg_sets": seg_sets,
            "n_boxes": int(n_boxes), "center": [float(c) for c in center],
            "radius": max(radius, 1.0)}
    with open(path, "w") as f:
        f.write(_HTML.replace("__DATA__", json.dumps(data)))
    return path
