"""Standalone WebGL Gaussian-splat viewer export.

Counterpart of ``geosplatting_tpu/visualization/viewer_html.py``: one
self-contained HTML file with the splats embedded base64 in the ``.splat``
layout (position 3 x f32 | scale 3 x f32 | rgba 4 x u8 | quaternion 4 x u8
= 32 bytes a Gaussian), drawn as instanced WebGL2 quads with the EWA 2D
covariance in the vertex shader and a JS depth sort when the camera moves;
orbit / pan / zoom with the mouse, no server and no network. For the same
splats the buffer and the page are the JAX package's, byte for byte.
"""
from __future__ import annotations

import base64
from pathlib import Path

import numpy as np

from .director import _host

_HTML = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>splats</title><style>
html,body{margin:0;height:100%;overflow:hidden;background:#111}
canvas{width:100%;height:100%;display:block}
#hud{position:fixed;left:8px;top:8px;color:#ccc;font:12px monospace}
</style></head><body>
<canvas id="c"></canvas><div id="hud"></div>
<script>
const B64 = "__DATA__";
const raw = Uint8Array.from(atob(B64), ch => ch.charCodeAt(0));
const N = raw.length / 32;
const f32 = new Float32Array(raw.buffer);
const u8 = raw;
const canvas = document.getElementById('c');
const gl = canvas.getContext('webgl2', {antialias: false});
const hud = document.getElementById('hud');
hud.textContent = N + ' gaussians';

const vsrc = `#version 300 es
precision highp float;
layout(location=0) in vec2 corner;
layout(location=1) in vec3 pos;
layout(location=2) in vec3 scale;
layout(location=3) in vec4 rgba;
layout(location=4) in vec4 quat;
uniform mat4 view; uniform vec2 focal; uniform vec2 vp;
out vec4 vColor; out vec2 vPix; out vec3 vConic;
void main(){
  vec4 cam = view * vec4(pos, 1.0);
  if (cam.z < 0.05) { gl_Position = vec4(0,0,2,1); return; }
  vec4 q = normalize(quat * 2.0 - 1.0);
  float w=q.x, x=q.y, y=q.z, z=q.w;
  mat3 R = mat3(
    1.-2.*(y*y+z*z), 2.*(x*y+w*z), 2.*(x*z-w*y),
    2.*(x*y-w*z), 1.-2.*(x*x+z*z), 2.*(y*z+w*x),
    2.*(x*z+w*y), 2.*(y*z-w*x), 1.-2.*(x*x+y*y));
  mat3 S = mat3(scale.x,0,0, 0,scale.y,0, 0,0,scale.z);
  mat3 M = R * S;
  mat3 V = mat3(view);
  mat3 Sigma = V * M * transpose(M) * transpose(V);
  float rz = 1.0 / cam.z;
  mat3 J = mat3(focal.x*rz,0,0, 0,focal.y*rz,0,
                -focal.x*cam.x*rz*rz, -focal.y*cam.y*rz*rz, 0);
  // GLSL mat3(col0, col1, col2): J's columns above already store the EWA
  // Jacobian's columns, so cov2d = J * Sigma * J^T maps directly
  mat3 C = J * Sigma * transpose(J);
  float a = C[0][0]+0.3, b = C[0][1], c = C[1][1]+0.3;
  float det = a*c - b*b;
  if (det <= 0.0) { gl_Position = vec4(0,0,2,1); return; }
  float mid = 0.5*(a+c);
  float l1 = mid + sqrt(max(mid*mid-det, 0.01));
  float r = min(3.0*sqrt(l1), 1024.0);
  vPix = corner * r;
  vColor = rgba;
  vConic = vec3(c/det, -b/det, a/det);
  vec2 center = vec2(focal.x*cam.x*rz, focal.y*cam.y*rz);
  vec2 ndc = (center + vPix) / (0.5*vp);
  gl_Position = vec4(ndc.x, -ndc.y, 0.0, 1.0);
}`;
const fsrc = `#version 300 es
precision highp float;
in vec4 vColor; in vec2 vPix; in vec3 vConic;
out vec4 frag;
void main(){
  float s = 0.5*(vConic.x*vPix.x*vPix.x + vConic.z*vPix.y*vPix.y)
            + vConic.y*vPix.x*vPix.y;
  if (s < 0.0) discard;
  float alpha = vColor.a * exp(-s);
  if (alpha < 1.0/255.0) discard;
  frag = vec4(vColor.rgb * alpha, alpha);
}`;
function sh(type, src){
  const s = gl.createShader(type); gl.shaderSource(s, src); gl.compileShader(s);
  if (!gl.getShaderParameter(s, gl.COMPILE_STATUS))
    throw gl.getShaderInfoLog(s);
  return s;
}
const prog = gl.createProgram();
gl.attachShader(prog, sh(gl.VERTEX_SHADER, vsrc));
gl.attachShader(prog, sh(gl.FRAGMENT_SHADER, fsrc));
gl.linkProgram(prog);
if (!gl.getProgramParameter(prog, gl.LINK_STATUS)) throw gl.getProgramInfoLog(prog);
gl.useProgram(prog);

const quad = new Float32Array([-1,-1, 1,-1, -1,1, 1,1]);
const qb = gl.createBuffer();
gl.bindBuffer(gl.ARRAY_BUFFER, qb);
gl.bufferData(gl.ARRAY_BUFFER, quad, gl.STATIC_DRAW);
gl.enableVertexAttribArray(0);
gl.vertexAttribPointer(0, 2, gl.FLOAT, false, 0, 0);

const inst = gl.createBuffer();
let order = new Uint32Array(N);
let sorted = new Uint8Array(N * 32);
function resort(view){
  const depths = new Float32Array(N);
  for (let i = 0; i < N; i++){
    const px = f32[i*8], py = f32[i*8+1], pz = f32[i*8+2];
    depths[i] = view[2]*px + view[6]*py + view[10]*pz + view[14];
    order[i] = i;
  }
  // back-to-front for premultiplied OVER blending
  order = Uint32Array.from(
    Array.from(order).sort((a, b) => depths[b] - depths[a]));
  const s32 = new Uint32Array(sorted.buffer);
  const r32 = new Uint32Array(raw.buffer);
  for (let i = 0; i < N; i++){
    const src = order[i] * 8, dst = i * 8;
    for (let k = 0; k < 8; k++) s32[dst + k] = r32[src + k];
  }
  gl.bindBuffer(gl.ARRAY_BUFFER, inst);
  gl.bufferData(gl.ARRAY_BUFFER, sorted, gl.DYNAMIC_DRAW);
  const stride = 32;
  gl.enableVertexAttribArray(1);
  gl.vertexAttribPointer(1, 3, gl.FLOAT, false, stride, 0);
  gl.vertexAttribDivisor(1, 1);
  gl.enableVertexAttribArray(2);
  gl.vertexAttribPointer(2, 3, gl.FLOAT, false, stride, 12);
  gl.vertexAttribDivisor(2, 1);
  gl.enableVertexAttribArray(3);
  gl.vertexAttribPointer(3, 4, gl.UNSIGNED_BYTE, true, stride, 24);
  gl.vertexAttribDivisor(3, 1);
  gl.enableVertexAttribArray(4);
  gl.vertexAttribPointer(4, 4, gl.UNSIGNED_BYTE, true, stride, 28);
  gl.vertexAttribDivisor(4, 1);
}

let theta = 0.6, phi = 0.9, dist = 3.0, target = [0, 0, 0];
function viewMatrix(){
  const ct = Math.cos(theta), st = Math.sin(theta);
  const cp = Math.cos(phi), sp = Math.sin(phi);
  const eye = [target[0] + dist*cp*ct, target[1] + dist*cp*st,
               target[2] + dist*sp];
  const f = norm3([target[0]-eye[0], target[1]-eye[1], target[2]-eye[2]]);
  const upW = [0, 0, 1];
  const r = norm3(cross(f, upW));
  const u = cross(r, f);
  // camera looks +z in view space (y down): rows r, -u, f
  const R = [r, [-u[0], -u[1], -u[2]], f];
  const m = new Float32Array(16);
  for (let i = 0; i < 3; i++){
    m[i*4+0] = R[0][i]; m[i*4+1] = R[1][i]; m[i*4+2] = R[2][i]; m[i*4+3] = 0;
  }
  m[12] = -(R[0][0]*eye[0] + R[0][1]*eye[1] + R[0][2]*eye[2]);
  m[13] = -(R[1][0]*eye[0] + R[1][1]*eye[1] + R[1][2]*eye[2]);
  m[14] = -(R[2][0]*eye[0] + R[2][1]*eye[1] + R[2][2]*eye[2]);
  m[15] = 1;
  return m;
}
function cross(a, b){
  return [a[1]*b[2]-a[2]*b[1], a[2]*b[0]-a[0]*b[2], a[0]*b[1]-a[1]*b[0]];
}
function norm3(a){
  const l = Math.hypot(a[0], a[1], a[2]) || 1;
  return [a[0]/l, a[1]/l, a[2]/l];
}

let dirty = true;
canvas.addEventListener('mousemove', e => {
  if (e.buttons & 1){ theta -= e.movementX*0.005; phi += e.movementY*0.005;
    phi = Math.max(-1.5, Math.min(1.5, phi)); dirty = true; }
  if (e.buttons & 2){
    target[0] -= e.movementX*0.002*dist; target[2] += e.movementY*0.002*dist;
    dirty = true; }
});
canvas.addEventListener('wheel', e => {
  dist *= Math.exp(e.deltaY*0.001); dirty = true; e.preventDefault();
});
canvas.addEventListener('contextmenu', e => e.preventDefault());

function draw(){
  const dpr = window.devicePixelRatio || 1;
  const w = canvas.clientWidth*dpr, h = canvas.clientHeight*dpr;
  if (canvas.width !== w || canvas.height !== h){
    canvas.width = w; canvas.height = h; dirty = true;
  }
  if (dirty){
    const view = viewMatrix();
    resort(view);
    gl.viewport(0, 0, w, h);
    gl.clearColor(0.07, 0.07, 0.07, 1);
    gl.clear(gl.COLOR_BUFFER_BIT);
    gl.enable(gl.BLEND);
    gl.blendFunc(gl.ONE, gl.ONE_MINUS_SRC_ALPHA);
    gl.disable(gl.DEPTH_TEST);
    gl.uniformMatrix4fv(gl.getUniformLocation(prog, 'view'), false, view);
    const focal = 0.8 * h;
    gl.uniform2f(gl.getUniformLocation(prog, 'focal'), focal, focal);
    gl.uniform2f(gl.getUniformLocation(prog, 'vp'), w, h);
    gl.drawArraysInstanced(gl.TRIANGLE_STRIP, 0, 4, N);
    dirty = false;
  }
  requestAnimationFrame(draw);
}
draw();
</script></body></html>
"""


def splats_to_buffer(
    means: np.ndarray, scales: np.ndarray, quats: np.ndarray,
    opacities: np.ndarray, colors: np.ndarray,
) -> bytes:
    """Pack gaussians into the 32-byte/splat ``.splat`` layout. ``scales``
    linear, ``opacities``/``colors`` in [0, 1], ``quats`` wxyz."""
    n = means.shape[0]
    rec = np.zeros((n, 32), np.uint8)
    rec[:, 0:12] = np.asarray(means, "<f4").view(np.uint8).reshape(n, 12)
    rec[:, 12:24] = np.asarray(scales, "<f4").view(np.uint8).reshape(n, 12)
    rgba = np.concatenate(
        [np.clip(colors, 0, 1), np.clip(opacities, 0, 1)[:, None]], -1
    )
    rec[:, 24:28] = (rgba * 255).astype(np.uint8)
    q = np.asarray(quats, np.float32)
    q = q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-8)
    rec[:, 28:32] = ((q * 0.5 + 0.5) * 255).astype(np.uint8)
    return rec.tobytes()


def _write_html(buf: bytes, path: Path | str) -> Path:
    html = _HTML.replace("__DATA__", base64.b64encode(buf).decode())
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(html)
    return path


def vis_3dgs(splats, path: Path | str) -> Path:
    """Write a standalone HTML viewer for a ``Splats`` (or a dict of
    ``means``, ``scales`` (log), ``quats``, ``opacities`` (logit),
    ``colors``; tensors or arrays). Returns the written path."""
    if isinstance(splats, dict):
        def get(k):
            return _host(splats[k])
    else:
        def get(k):
            return _host(getattr(splats, k))
    means = get("means")
    scales = np.exp(get("scales"))
    quats = get("quats")
    opac = get("opacities").reshape(len(means), -1)[:, 0]
    opac = 1.0 / (1.0 + np.exp(-opac))          # stored as logits
    colors = np.clip(get("colors"), 0.0, 1.0)
    return _write_html(splats_to_buffer(means, scales, quats, opac, colors), path)


def vis_colmap(
    path: Path | str,
    out: Path | str,
    *,
    auto_orient: bool = True,
    max_num_points: int = 40_000,
    frustum_scale: float = 0.06,
    seed: int = 0,
) -> Path:
    """A COLMAP sparse model as a standalone HTML page: read with the
    port's COLMAP readers, mean-centred, the mean camera-up turned to +z
    (``auto_orient``) and rescaled so the 0.9 quantile of |xyz| lands at
    0.9; the SfM points (at most ``max_num_points``, drawn with
    ``np.random.default_rng(seed)``) and a wireframe frustum per registered
    camera as tiny splats through the viewer above."""
    from ..data.dataparsers.colmap import _qvec2rot, _read_images_bin, _read_points3d_bin

    path = Path(path)
    sparse = None
    for cand in (path / "sparse" / "0", path / "sparse",
                 path / "colmap" / "sparse" / "0"):
        if (cand / "images.bin").exists():
            sparse = cand
            break
    if sparse is None:
        raise FileNotFoundError(f"no COLMAP sparse model under {path}")
    images = _read_images_bin(sparse / "images.bin")
    xyz, rgb = _read_points3d_bin(sparse / "points3D.bin")

    c2ws = []
    for im in images:
        r = _qvec2rot(im["qvec"])
        c2w = np.eye(4, dtype=np.float64)
        c2w[:3, :3] = r.T
        c2w[:3, 3] = -r.T @ im["tvec"]
        c2w[:3, 1:3] *= -1  # COLMAP +z/-y -> OpenGL -z/+y
        c2ws.append(c2w)
    poses = np.asarray(c2ws)                      # [N, 4, 4]

    offset = xyz.mean(0)
    poses[:, :3, 3] -= offset
    xyz = xyz - offset
    if auto_orient and len(poses):
        up = poses[:, :3, 1].mean(0)
        up = up / max(np.linalg.norm(up), 1e-9)
        z = np.array([0.0, 0.0, 1.0])
        v = np.cross(up, z)
        c = float(up @ z)
        vx = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
        rot = np.eye(3) + vx + vx @ vx / max(1 + c, 1e-9)
        poses[:, :3, :3] = rot[None] @ poses[:, :3, :3]
        poses[:, :3, 3] = poses[:, :3, 3] @ rot.T
        xyz = xyz @ rot.T
    rescale = 0.9 / max(np.quantile(np.abs(xyz).reshape(-1), 0.9), 1e-9)
    poses[:, :3, 3] *= rescale
    xyz = xyz * rescale

    rng = np.random.default_rng(seed)
    if len(xyz) > max_num_points:
        pick = rng.choice(len(xyz), size=max_num_points, replace=False)
        xyz, rgb = xyz[pick], rgb[pick]

    # camera frusta: points sampled along the 8 wireframe edges
    fr_pts, fr_cols = [], []
    corners = np.array([
        [-1, -0.6, -1.5], [1, -0.6, -1.5], [1, 0.6, -1.5], [-1, 0.6, -1.5],
    ]) * frustum_scale
    t_samples = np.linspace(0.0, 1.0, 6)[:, None]
    for c2w in poses:
        rot_, tr = c2w[:3, :3], c2w[:3, 3]
        cs = corners @ rot_.T + tr
        for a, b in [(0, 1), (1, 2), (2, 3), (3, 0)]:
            fr_pts.append(cs[a] * (1 - t_samples) + cs[b] * t_samples)
        for corner in cs:
            fr_pts.append(tr * (1 - t_samples) + corner * t_samples)
    if fr_pts:
        fr_pts = np.concatenate(fr_pts)
        fr_cols = np.broadcast_to(
            np.array([1.0, 0.62, 0.15]), fr_pts.shape
        ).copy()
        xyz = np.concatenate([xyz, fr_pts])
        rgb = np.concatenate([rgb, fr_cols])

    n = len(xyz)
    means = xyz.astype(np.float32)
    scales = np.full((n, 3), 0.004, np.float32)
    quats = np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1))
    opac = np.full((n,), 0.95, np.float32)
    buf = splats_to_buffer(means, scales, quats, opac,
                           np.clip(rgb, 0, 1).astype(np.float32))
    return _write_html(buf, out)
