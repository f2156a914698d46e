"""Live viewer of a SLAM run (port of fourdgs/gui/viewer.py).

Headless and web-first, with the control surface of the reference's
desktop GUI:

  * every `interval` frames it renders (a) the current tracked view and
    (b) a novel view at an orbit offset, both through the port's
    rasterizer on the SLAM object's device (one forward launch of the
    compositor each, at 1 view), (c) a depth visualization, (d) a
    top-down trajectory/keyframe plot, and (e) the 3D scene payload
    (points.bin + scene.json) read by the page's WebGL point cloud and
    camera frustums;
  * with a port, an HTTP server serves the images and a control channel:
    `GET /ctl?cmd=pause|resume` and `GET /ctl?cmd=orbit&yaw=..&x=..`
    pause the run and move the novel view live; the runner calls
    `wait_if_paused()` once per frame;
  * without a port it only writes the files.

`close()` stops the server and frees its port; the runner calls it at the
end of `run()` (the reference leaves its server thread running).
"""

from __future__ import annotations

import http.server
import json
import os
import threading
import urllib.parse
from typing import NamedTuple

import numpy as np
import torch


class GaussianSnapshot(NamedTuple):
    """Host-side snapshot of the map and camera state."""

    n_gaussians: int
    n_dynamic: int
    frame_idx: int
    T_cw: np.ndarray


# Static page (header filled live from status.json). The right-hand canvas
# is a dependency-free WebGL scene view: splat centres as a coloured point
# cloud (dynamic Gaussians tinted orange) plus keyframe/current camera
# frustums with drag-orbit and wheel-zoom.
_INDEX_HTML = """<!doctype html>
<html><head><title>4DGS-SLAM live</title>
<style>body{background:#111;color:#eee;font-family:monospace}
img{image-rendering:pixelated;max-width:24%}
canvas{border:1px solid #333;touch-action:none}
button{margin:2px;padding:4px 12px}</style></head>
<body><h3 id="hdr">4DGS-SLAM — loading…</h3>
<div>
<button onclick="fetch('/ctl?cmd=pause')">pause</button>
<button onclick="fetch('/ctl?cmd=resume')">resume</button>
yaw <input type="range" id="yaw" min="-90" max="90" value="15"
 onchange="orbit()">
x <input type="range" id="x" min="-100" max="100" value="15"
 onchange="orbit()">
</div>
<img src="current.png"><img src="novel.png"><img src="depth.png">
<img src="trajectory.png">
<div><canvas id="gl" width="640" height="480"></canvas></div>
<script>
function orbit(){
  fetch('/ctl?cmd=orbit&yaw='+document.getElementById('yaw').value
        +'&x='+document.getElementById('x').value);}
setInterval(()=>{fetch('status.json').then(r=>r.json()).then(s=>{
  document.getElementById('hdr').textContent =
    `4DGS-SLAM — frame ${s.frame}, ${s.n} gaussians `+
    `(${s.ndy} dynamic)`+(s.paused?' [PAUSED]':'');
  for (const im of document.images) {
    const u = new URL(im.src); u.searchParams.set('t', Date.now());
    im.src = u.href; }
}).catch(()=>{})}, 2000);

// ---- 3D scene view (raw WebGL, no libraries) ----
const cv = document.getElementById('gl');
const gl = cv.getContext('webgl');
let nPts = 0, lineVerts = 0, center = [0,0,0];
let theta = -0.5, phi = 0.4, radius = 6;
function sh(type, src){const s = gl.createShader(type);
  gl.shaderSource(s, src); gl.compileShader(s); return s;}
const prog = gl.createProgram();
gl.attachShader(prog, sh(gl.VERTEX_SHADER, `
  attribute vec3 p; attribute vec3 c; uniform mat4 mvp; uniform float ps;
  varying vec3 vc;
  void main(){ gl_Position = mvp*vec4(p,1.0);
    gl_PointSize = clamp(ps/gl_Position.w, 1.0, 6.0); vc = c; }`));
gl.attachShader(prog, sh(gl.FRAGMENT_SHADER, `
  precision mediump float; varying vec3 vc;
  void main(){ gl_FragColor = vec4(vc,1.0); }`));
gl.linkProgram(prog); gl.useProgram(prog);
const aP = gl.getAttribLocation(prog,'p');
const aC = gl.getAttribLocation(prog,'c');
const uM = gl.getUniformLocation(prog,'mvp');
const uS = gl.getUniformLocation(prog,'ps');
const pBuf = gl.createBuffer(), lBuf = gl.createBuffer();
function matmul(a,b){const o = new Float32Array(16);
  for(let i=0;i<4;i++)for(let j=0;j<4;j++){let s=0;
    for(let k=0;k<4;k++)s+=a[k*4+j]*b[i*4+k]; o[i*4+j]=s;} return o;}
function mvp(){
  const cx=Math.cos(theta),sx=Math.sin(theta);
  const cy=Math.cos(phi),sy=Math.sin(phi);
  const eye=[center[0]+radius*cy*sx, center[1]-radius*sy,
             center[2]-radius*cy*cx];
  let f=[center[0]-eye[0],center[1]-eye[1],center[2]-eye[2]];
  const fl=Math.hypot(...f); f=f.map(v=>v/fl);
  let up=[0,-1,0];
  let s=[f[1]*up[2]-f[2]*up[1],f[2]*up[0]-f[0]*up[2],f[0]*up[1]-f[1]*up[0]];
  const sln=Math.hypot(...s); s=s.map(v=>v/sln);
  const u=[s[1]*f[2]-s[2]*f[1],s[2]*f[0]-s[0]*f[2],s[0]*f[1]-s[1]*f[0]];
  const view=new Float32Array([s[0],u[0],-f[0],0, s[1],u[1],-f[1],0,
    s[2],u[2],-f[2],0,
    -(s[0]*eye[0]+s[1]*eye[1]+s[2]*eye[2]),
    -(u[0]*eye[0]+u[1]*eye[1]+u[2]*eye[2]),
    (f[0]*eye[0]+f[1]*eye[1]+f[2]*eye[2]),1]);
  const n=0.02,fa=200,t=n*Math.tan(0.4),r=t*cv.width/cv.height;
  const proj=new Float32Array([n/r,0,0,0, 0,n/t,0,0,
    0,0,-(fa+n)/(fa-n),-1, 0,0,-2*fa*n/(fa-n),0]);
  return matmul(proj,view);}
gl.enable(gl.DEPTH_TEST);
function draw(){
  gl.viewport(0,0,cv.width,cv.height);
  gl.clearColor(0.04,0.04,0.06,1);
  gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT);
  gl.uniformMatrix4fv(uM,false,mvp());
  gl.enableVertexAttribArray(aP); gl.enableVertexAttribArray(aC);
  if(nPts){ gl.bindBuffer(gl.ARRAY_BUFFER,pBuf);
    gl.vertexAttribPointer(aP,3,gl.FLOAT,false,24,0);
    gl.vertexAttribPointer(aC,3,gl.FLOAT,false,24,12);
    gl.uniform1f(uS,8.0); gl.drawArrays(gl.POINTS,0,nPts); }
  if(lineVerts){ gl.bindBuffer(gl.ARRAY_BUFFER,lBuf);
    gl.vertexAttribPointer(aP,3,gl.FLOAT,false,24,0);
    gl.vertexAttribPointer(aC,3,gl.FLOAT,false,24,12);
    gl.drawArrays(gl.LINES,0,lineVerts); }
  requestAnimationFrame(draw);}
function frustum(T,col,out){ // T: world-from-camera, row-major 4x4
  const d=0.25,w=0.33*d,h=0.25*d;
  const pts=[[0,0,0],[-w,-h,d],[w,-h,d],[w,h,d],[-w,h,d]].map(p=>[
    T[0]*p[0]+T[1]*p[1]+T[2]*p[2]+T[3],
    T[4]*p[0]+T[5]*p[1]+T[6]*p[2]+T[7],
    T[8]*p[0]+T[9]*p[1]+T[10]*p[2]+T[11]]);
  const e=[[0,1],[0,2],[0,3],[0,4],[1,2],[2,3],[3,4],[4,1]];
  for(const [i,j] of e){ out.push(...pts[i],...col,...pts[j],...col); }}
function loadScene(){
  fetch('points.bin?t='+Date.now()).then(r=>r.arrayBuffer()).then(b=>{
    const a=new Float32Array(b); const n=(a.length/7)|0;
    const v=new Float32Array(n*6); let sx=0,sy=0,sz=0;
    for(let i=0;i<n;i++){ const o=i*7;
      v[i*6]=a[o]; v[i*6+1]=a[o+1]; v[i*6+2]=a[o+2];
      sx+=a[o]; sy+=a[o+1]; sz+=a[o+2];
      const dyn=a[o+6]>0.5;
      v[i*6+3]=dyn?1.0:a[o+3]; v[i*6+4]=dyn?0.55:a[o+4];
      v[i*6+5]=dyn?0.1:a[o+5]; }
    if(n){ center=[sx/n,sy/n,sz/n]; }
    gl.bindBuffer(gl.ARRAY_BUFFER,pBuf);
    gl.bufferData(gl.ARRAY_BUFFER,v,gl.DYNAMIC_DRAW); nPts=n;
  }).catch(()=>{});
  fetch('scene.json?t='+Date.now()).then(r=>r.json()).then(s=>{
    const out=[];
    for(const T of s.kf){ frustum(T,[0.3,0.6,1.0],out); }
    if(s.cur){ frustum(s.cur,[1,1,1],out); }
    gl.bindBuffer(gl.ARRAY_BUFFER,lBuf);
    gl.bufferData(gl.ARRAY_BUFFER,new Float32Array(out),gl.DYNAMIC_DRAW);
    lineVerts=(out.length/6)|0;
  }).catch(()=>{});}
let drag=false,lx=0,ly=0;
cv.addEventListener('pointerdown',e=>{drag=true;lx=e.clientX;ly=e.clientY;});
window.addEventListener('pointerup',()=>drag=false);
window.addEventListener('pointermove',e=>{ if(!drag)return;
  theta+=(e.clientX-lx)*0.008; phi+=(e.clientY-ly)*0.008;
  phi=Math.max(-1.5,Math.min(1.5,phi)); lx=e.clientX; ly=e.clientY;});
cv.addEventListener('wheel',e=>{ e.preventDefault();
  radius*=Math.exp(e.deltaY*0.001); radius=Math.max(0.2,radius);});
loadScene(); setInterval(loadScene, 2000); draw();
</script>
</body></html>
"""


def write_scene(
    dirpath: str,
    xyz: np.ndarray,              # (N, 3) alive splat centres (world)
    rgb: np.ndarray,              # (N, 3) linear colour in [0, 1]
    dyn: np.ndarray,              # (N,) bool dynamic-Gaussian flag
    kf_poses: list[np.ndarray],   # world-from-camera 4x4 per keyframe
    cur_pose: np.ndarray | None,  # world-from-camera 4x4, current frame
    max_points: int = 1 << 15,
) -> int:
    """Write the 3D scene-view payload: `points.bin` (float32 rows
    [x y z r g b dyn], strided down to <= max_points) and `scene.json`
    (row-major frustum poses). Returns the number of points written."""
    n = xyz.shape[0]
    if n > max_points:
        step = -(-n // max_points)
        xyz, rgb, dyn = xyz[::step], rgb[::step], dyn[::step]
        n = xyz.shape[0]
    buf = np.concatenate([xyz.astype(np.float32), np.clip(rgb, 0.0, 1.0).astype(np.float32),
                          dyn.astype(np.float32)[:, None]], axis=1)
    buf.tofile(os.path.join(dirpath, "points.bin"))
    scene = {
        "n_points": int(n),
        "kf": [np.asarray(T, np.float64).reshape(-1).tolist() for T in kf_poses],
        "cur": (np.asarray(cur_pose, np.float64).reshape(-1).tolist()
                if cur_pose is not None else None),
    }
    with open(os.path.join(dirpath, "scene.json"), "w") as f:
        json.dump(scene, f)
    return n


def _save_png(path: str, img: np.ndarray) -> None:
    from PIL import Image

    arr = np.clip(img, 0, 1)
    if arr.ndim == 3 and arr.shape[0] in (1, 3):
        arr = arr.transpose(1, 2, 0)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, -1)
    Image.fromarray((arr * 255).astype(np.uint8)).save(path)


def _colorize_depth(depth: np.ndarray) -> np.ndarray:
    """(H, W) depth -> (H, W, 3) ramp between its 2nd and 98th
    percentiles; invalid (<= 0) pixels black."""
    d = depth.copy()
    valid = d > 0
    if valid.any():
        lo, hi = np.percentile(d[valid], [2, 98])
        d = np.clip((d - lo) / max(hi - lo, 1e-6), 0, 1)
    r = np.clip(1.5 - np.abs(2.0 * d - 1.5), 0, 1)
    g = np.clip(1.5 - np.abs(2.0 * d - 1.0), 0, 1)
    b = np.clip(1.5 - np.abs(2.0 * d - 0.5), 0, 1)
    out = np.stack([r, g, b], -1)
    out[~valid] = 0
    return out


def _trajectory_plot(poses: dict, kf_indices, size: int = 256) -> np.ndarray:
    """Top-down (x, z) trajectory of the camera centres, keyframes marked
    orange and the current camera as a white cross."""
    img = np.zeros((size, size, 3), np.float32)
    if not poses:
        return img
    idxs = sorted(poses)
    centers = np.stack([np.linalg.inv(poses[i])[:3, 3] for i in idxs])
    xz = centers[:, [0, 2]]
    lo = xz.min(0) - 1e-3
    hi = xz.max(0) + 1e-3
    span = np.maximum(hi - lo, 1e-2).max()
    uv = ((xz - lo) / span * (size - 17) + 8).astype(int)
    uv = np.clip(uv, 0, size - 1)
    kfs = set(int(k) for k in kf_indices)
    for j, (u, v) in enumerate(uv):
        img[size - 1 - v, u] = (0.3, 0.9, 0.3)
        if idxs[j] in kfs:
            img[max(size - 3 - v, 0):size - v + 1, max(u - 1, 0):u + 2] = (0.9, 0.4, 0.1)
    u, v = uv[-1]
    img[size - 1 - v, max(u - 3, 0):u + 4] = 1.0
    img[max(size - 4 - v, 0):size + 2 - v, u] = 1.0
    return img


def render_views(slam, T_cw, orbit):
    """The current view at T_cw (4, 4) and the novel view at
    se3_exp(orbit) @ T_cw of the SLAM object's map, on its device:
    two `RenderOutputs`."""
    from fourdgs_torch.geometry.se3 import se3_exp
    from fourdgs_torch.slam.mapping import render_keyframe

    T = torch.as_tensor(np.array(T_cw, np.float32), device=slam.device)
    tau = torch.as_tensor(np.asarray(orbit, np.float32), device=slam.device)
    return (render_keyframe(slam.gmap, T, slam.intr, slam.map_cfg),
            render_keyframe(slam.gmap, se3_exp(tau) @ T, slam.intr, slam.map_cfg))


class LiveViewer:
    def __init__(self, save_dir: str, interval: int = 50, serve_port: int | None = None):
        self.dir = os.path.join(save_dir, "gui")
        os.makedirs(self.dir, exist_ok=True)
        self.interval = max(1, interval)
        self._httpd = None
        self._thread = None
        # control state, written by the HTTP thread and read by the runner
        self._unpaused = threading.Event()
        self._unpaused.set()
        self.orbit = np.asarray([0.15, -0.05, 0.0, 0.0, 0.25, 0.0], np.float32)
        self._last = {"frame": 0, "n": 0, "ndy": 0}
        with open(os.path.join(self.dir, "index.html"), "w") as f:
            f.write(_INDEX_HTML)
        if serve_port is not None:
            self._serve(serve_port)

    # ---- control channel -------------------------------------------------
    @property
    def paused(self) -> bool:
        return not self._unpaused.is_set()

    def pause(self):
        self._unpaused.clear()
        self._write_status()

    def resume(self):
        self._unpaused.set()
        self._write_status()

    def wait_if_paused(self, timeout: float | None = None):
        """Block while paused (the runner calls this once per frame)."""
        self._unpaused.wait(timeout=timeout)

    def _ctl(self, query: str):
        q = urllib.parse.parse_qs(query)
        cmd = q.get("cmd", [""])[0]
        if cmd == "pause":
            self.pause()
        elif cmd == "resume":
            self.resume()
        elif cmd == "orbit":
            yaw = float(q.get("yaw", [15])[0]) * np.pi / 180.0
            x = float(q.get("x", [15])[0]) / 100.0
            self.orbit = np.asarray([x, -0.05, 0.0, 0.0, yaw, 0.0], np.float32)

    def _serve(self, port: int):
        directory = self.dir
        viewer = self

        class Handler(http.server.SimpleHTTPRequestHandler):
            def __init__(self, *a, **k):
                super().__init__(*a, directory=directory, **k)

            def do_GET(self):
                if self.path.startswith("/ctl"):
                    viewer._ctl(urllib.parse.urlsplit(self.path).query)
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.end_headers()
                    self.wfile.write(json.dumps({"paused": viewer.paused}).encode())
                    return
                super().do_GET()

            def log_message(self, *a):
                pass

        self._httpd = http.server.ThreadingHTTPServer(("0.0.0.0", port), Handler)
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()

    # ---- snapshot rendering ---------------------------------------------
    def _write_status(self):
        with open(os.path.join(self.dir, "status.json"), "w") as f:
            json.dump(dict(self._last, paused=self.paused), f)

    def maybe_update(self, slam, frame_idx: int) -> GaussianSnapshot | None:
        """Called by the runner after each frame's tracking; renders and
        writes every `interval` frames."""
        if frame_idx % self.interval != 0:
            return None
        from fourdgs_torch.geometry.sh import sh0_to_rgb

        T = np.asarray(slam.poses_est[frame_idx], np.float32)
        cur, novel = render_views(slam, T, self.orbit)
        _save_png(os.path.join(self.dir, "current.png"), cur.color.cpu().numpy())
        _save_png(os.path.join(self.dir, "novel.png"), novel.color.cpu().numpy())
        _save_png(os.path.join(self.dir, "depth.png"), _colorize_depth(cur.depth.cpu().numpy()))
        kf_indices = getattr(slam, "kf_indices", ())
        _save_png(os.path.join(self.dir, "trajectory.png"),
                  _trajectory_plot(slam.poses_est, kf_indices))
        gmap = slam.gmap
        alive = gmap.alive.cpu().numpy()
        sel = np.nonzero(alive)[0]
        kf_poses = [np.linalg.inv(np.asarray(slam.poses_est[int(k)])) for k in kf_indices
                    if int(k) in slam.poses_est]
        rgb = sh0_to_rgb(gmap.params.f_dc.detach()).cpu().numpy()
        dygs = gmap.dygs.cpu().numpy()
        write_scene(self.dir, gmap.params.xyz.detach().cpu().numpy()[sel], rgb[sel], dygs[sel],
                    kf_poses, np.linalg.inv(T))
        snap = GaussianSnapshot(n_gaussians=int(alive.sum()), n_dynamic=int((dygs & alive).sum()),
                                frame_idx=frame_idx, T_cw=T)
        self._last = {"frame": frame_idx, "n": snap.n_gaussians, "ndy": snap.n_dynamic}
        self._write_status()
        return snap

    def close(self):
        """Stop the server, free its port and join its thread."""
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._thread.join(timeout=5)
            self._httpd = self._thread = None
