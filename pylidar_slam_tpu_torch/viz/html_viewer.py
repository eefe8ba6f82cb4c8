"""Interactive 3D map viewer: one self-contained HTML file (torch port of
``pylidar_slam_tpu.viz.html_viewer``, page text included).

The registered map (quantized positions + colors) and the trajectory ride
as base64 strings inside the page, drawn by an inline vanilla-WebGL point
renderer with orbit / pan / zoom controls; the file opens from disk in any
browser, with no network and no server.

Encoding: positions are uint16-quantized against the cloud's bounding box
(dequantized in the vertex shader -- 6 B/point instead of 12), colors are
uint8 RGB, the trajectory stays float32.  For the same inputs the payloads
are the JAX package's.
"""
from __future__ import annotations

import base64
import json
from pathlib import Path
from typing import Optional

import numpy as np

from pylidar_slam_tpu_torch.viz.color_map import scalar_gray_cmap


def _b64(arr: np.ndarray) -> str:
    return base64.b64encode(np.ascontiguousarray(arr).tobytes()).decode()


def _height_colors(points: np.ndarray) -> np.ndarray:
    """(N, 3) uint8 colors by z (viridis, matplotlib's colors)."""
    z = points[:, 2].astype(np.float64)
    lo, hi = np.quantile(z, 0.02), np.quantile(z, 0.98)
    t = np.clip((z - lo) / max(hi - lo, 1e-9), 0.0, 1.0)
    rgb = scalar_gray_cmap(t, "viridis", 0.0, 1.0)
    return np.clip(rgb * 255.0, 0, 255).astype(np.uint8)


def write_html_viewer(file_path: str,
                      points: np.ndarray,
                      colors: Optional[np.ndarray] = None,
                      trajectory: Optional[np.ndarray] = None,
                      title: str = "pylidar-slam-tpu map",
                      max_points: int = 600_000,
                      point_size: float = 2.0) -> str:
    """Writes a standalone interactive WebGL viewer for a point cloud.

    points: (N, 3) float; colors: optional (N, 3) uint8 or [0,1] float;
    trajectory: optional (T, 3) positions or (T, 4, 4) pose matrices.
    Returns the written path.  Controls: drag = orbit, wheel = zoom,
    right-drag / shift-drag = pan, +/- = point size, t = trajectory,
    r = reset view.
    """
    pts = np.asarray(points, np.float32)
    assert pts.ndim == 2 and pts.shape[1] == 3, pts.shape
    if colors is not None:
        colors = np.asarray(colors)
        if colors.dtype != np.uint8:
            colors = np.clip(colors * 255.0, 0, 255).astype(np.uint8)
        assert colors.shape == pts.shape, (colors.shape, pts.shape)
    if pts.shape[0] > max_points:
        step = pts.shape[0] // max_points + 1
        pts = pts[::step]
        colors = colors[::step] if colors is not None else None
    if colors is None:
        colors = _height_colors(pts)

    lo = pts.min(axis=0)
    hi = pts.max(axis=0)
    span = np.maximum(hi - lo, 1e-6)
    quant = np.round((pts - lo) / span * 65535.0).astype(np.uint16)

    traj = None
    if trajectory is not None:
        traj = np.asarray(trajectory, np.float32)
        if traj.ndim == 3:  # (T, 4, 4) poses -> positions
            traj = traj[:, :3, 3]
        assert traj.ndim == 2 and traj.shape[1] == 3, traj.shape

    meta = {
        "n": int(quant.shape[0]),
        "lo": [float(v) for v in lo],
        "span": [float(v) for v in span],
        "nTraj": 0 if traj is None else int(traj.shape[0]),
        "pointSize": float(point_size),
        "title": title,
    }
    html = (_TEMPLATE
            .replace("__TITLE__", title)
            .replace("__META__", json.dumps(meta))
            .replace("__POS_B64__", _b64(quant))
            .replace("__COL_B64__", _b64(colors))
            .replace("__TRAJ_B64__", "" if traj is None else _b64(traj)))
    Path(file_path).write_text(html)
    return file_path


# The inline viewer.  Plain WebGL1 + hand-rolled orbit camera: the point
# cloud is one gl.POINTS draw with uint16 positions dequantized in the
# vertex shader; the trajectory is one LINE_STRIP draw.
_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>__TITLE__</title><style>
 html,body{margin:0;height:100%;overflow:hidden;background:#10141a;font:12px monospace}
 canvas{width:100%;height:100%;display:block}
 #hud{position:fixed;left:8px;top:8px;color:#9fb4c7;user-select:none;
      background:rgba(16,20,26,.65);padding:6px 8px;border-radius:4px}
</style></head><body>
<canvas id="c"></canvas>
<div id="hud"></div>
<script>
"use strict";
const META = __META__;
function decode(b64, T){const s=atob(b64);const u=new Uint8Array(s.length);
  for(let i=0;i<s.length;i++)u[i]=s.charCodeAt(i);return new T(u.buffer);}
const pos = decode("__POS_B64__", Uint16Array);
const col = decode("__COL_B64__", Uint8Array);
const trajB64 = "__TRAJ_B64__";
const traj = trajB64 ? decode(trajB64, Float32Array) : null;

const canvas = document.getElementById("c");
const gl = canvas.getContext("webgl", {antialias:false});
const hud = document.getElementById("hud");

function shader(type, src){const s=gl.createShader(type);gl.shaderSource(s,src);
  gl.compileShader(s);
  if(!gl.getShaderParameter(s,gl.COMPILE_STATUS))throw gl.getShaderInfoLog(s);
  return s;}
function program(vs, fs){const p=gl.createProgram();
  gl.attachShader(p,shader(gl.VERTEX_SHADER,vs));
  gl.attachShader(p,shader(gl.FRAGMENT_SHADER,fs));gl.linkProgram(p);
  if(!gl.getProgramParameter(p,gl.LINK_STATUS))throw gl.getProgramInfoLog(p);
  return p;}

const ptProg = program(`
  attribute vec3 q; attribute vec3 rgb;
  uniform mat4 mvp; uniform vec3 lo, span; uniform float psize;
  varying vec3 vc;
  void main(){
    vec3 p = lo + q/65535.0*span;
    gl_Position = mvp*vec4(p,1.0);
    gl_PointSize = clamp(psize*40.0/gl_Position.w, 1.0, 12.0);
    vc = rgb/255.0;
  }`, `
  precision mediump float; varying vec3 vc;
  void main(){ gl_FragColor = vec4(vc,1.0); }`);

const lnProg = program(`
  attribute vec3 p; uniform mat4 mvp;
  void main(){ gl_Position = mvp*vec4(p,1.0); }`, `
  precision mediump float;
  void main(){ gl_FragColor = vec4(1.0,0.25,0.25,1.0); }`);

const posBuf = gl.createBuffer();
gl.bindBuffer(gl.ARRAY_BUFFER, posBuf);
gl.bufferData(gl.ARRAY_BUFFER, pos, gl.STATIC_DRAW);
const colBuf = gl.createBuffer();
gl.bindBuffer(gl.ARRAY_BUFFER, colBuf);
gl.bufferData(gl.ARRAY_BUFFER, col, gl.STATIC_DRAW);
let trajBuf = null;
if(traj){trajBuf=gl.createBuffer();gl.bindBuffer(gl.ARRAY_BUFFER,trajBuf);
  gl.bufferData(gl.ARRAY_BUFFER,traj,gl.STATIC_DRAW);}

// --- camera: orbit around target ------------------------------------------
const lo=META.lo, span=META.span;
const center=[lo[0]+span[0]/2, lo[1]+span[1]/2, lo[2]+span[2]/2];
const radius0=Math.max(span[0],span[1],span[2]);
let yaw=0.8, pitch=0.5, dist=radius0*1.4, tgt=center.slice();
let psize=META.pointSize, showTraj=true;

function mat_mul(a,b){const o=new Float32Array(16);
 for(let r=0;r<4;r++)for(let c=0;c<4;c++){let s=0;
  for(let k=0;k<4;k++)s+=a[k*4+c]*b[r*4+k];o[r*4+c]=s;}return o;}
function persp(fov,asp,near,far){const f=1/Math.tan(fov/2);
 return new Float32Array([f/asp,0,0,0, 0,f,0,0,
  0,0,(far+near)/(near-far),-1, 0,0,2*far*near/(near-far),0]);}
function lookAt(eye,at,up){
 let z=[eye[0]-at[0],eye[1]-at[1],eye[2]-at[2]];
 let zl=Math.hypot(...z);z=z.map(v=>v/zl);
 let x=[up[1]*z[2]-up[2]*z[1],up[2]*z[0]-up[0]*z[2],up[0]*z[1]-up[1]*z[0]];
 let xl=Math.hypot(...x);x=x.map(v=>v/xl);
 const y=[z[1]*x[2]-z[2]*x[1],z[2]*x[0]-z[0]*x[2],z[0]*x[1]-z[1]*x[0]];
 return new Float32Array([x[0],y[0],z[0],0, x[1],y[1],z[1],0,
  x[2],y[2],z[2],0,
  -(x[0]*eye[0]+x[1]*eye[1]+x[2]*eye[2]),
  -(y[0]*eye[0]+y[1]*eye[1]+y[2]*eye[2]),
  -(z[0]*eye[0]+z[1]*eye[1]+z[2]*eye[2]),1]);}

function draw(){
  const w=canvas.clientWidth, h=canvas.clientHeight;
  if(canvas.width!==w||canvas.height!==h){canvas.width=w;canvas.height=h;}
  gl.viewport(0,0,w,h);
  gl.clearColor(0.063,0.078,0.102,1.0);
  gl.enable(gl.DEPTH_TEST);
  gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT);
  const cp=Math.cos(pitch),sp=Math.sin(pitch);
  const eye=[tgt[0]+dist*cp*Math.cos(yaw),
             tgt[1]+dist*cp*Math.sin(yaw), tgt[2]+dist*sp];
  const mvp=mat_mul(persp(0.9,w/h,radius0*0.002,radius0*40),
                    lookAt(eye,tgt,[0,0,1]));
  gl.useProgram(ptProg);
  gl.uniformMatrix4fv(gl.getUniformLocation(ptProg,"mvp"),false,mvp);
  gl.uniform3fv(gl.getUniformLocation(ptProg,"lo"),lo);
  gl.uniform3fv(gl.getUniformLocation(ptProg,"span"),span);
  gl.uniform1f(gl.getUniformLocation(ptProg,"psize"),psize);
  const qLoc=gl.getAttribLocation(ptProg,"q");
  gl.bindBuffer(gl.ARRAY_BUFFER,posBuf);
  gl.enableVertexAttribArray(qLoc);
  gl.vertexAttribPointer(qLoc,3,gl.UNSIGNED_SHORT,false,0,0);
  const cLoc=gl.getAttribLocation(ptProg,"rgb");
  gl.bindBuffer(gl.ARRAY_BUFFER,colBuf);
  gl.enableVertexAttribArray(cLoc);
  gl.vertexAttribPointer(cLoc,3,gl.UNSIGNED_BYTE,false,0,0);
  gl.drawArrays(gl.POINTS,0,META.n);
  if(traj&&showTraj){
    gl.useProgram(lnProg);
    gl.uniformMatrix4fv(gl.getUniformLocation(lnProg,"mvp"),false,mvp);
    const pLoc=gl.getAttribLocation(lnProg,"p");
    gl.bindBuffer(gl.ARRAY_BUFFER,trajBuf);
    gl.enableVertexAttribArray(pLoc);
    gl.vertexAttribPointer(pLoc,3,gl.FLOAT,false,0,0);
    gl.drawArrays(gl.LINE_STRIP,0,META.nTraj);
  }
  hud.textContent = META.title+" -- "+META.n.toLocaleString()+" pts"
    +(traj?", "+META.nTraj+" poses":"")
    +" | drag orbit, wheel zoom, shift/right-drag pan, +/- size, t traj, r reset";
  requestAnimationFrame(draw);
}

// --- input ------------------------------------------------------------------
let drag=null;
canvas.addEventListener("contextmenu",e=>e.preventDefault());
canvas.addEventListener("mousedown",e=>{drag={x:e.clientX,y:e.clientY,
  pan:e.button===2||e.shiftKey};});
window.addEventListener("mouseup",()=>drag=null);
window.addEventListener("mousemove",e=>{
  if(!drag)return;
  const dx=e.clientX-drag.x, dy=e.clientY-drag.y;
  drag.x=e.clientX; drag.y=e.clientY;
  if(drag.pan){
    // Screen-space pan along the camera's right/up basis.
    const s=dist*0.0015;
    const cy=Math.cos(yaw),sy=Math.sin(yaw);
    const cp=Math.cos(pitch),sp=Math.sin(pitch);
    const right=[-sy,cy,0], up=[-sp*cy,-sp*sy,cp];
    for(let i=0;i<3;i++)tgt[i]+=(-dx*right[i]+dy*up[i])*s;
  }else{
    yaw-=dx*0.005;
    pitch=Math.min(1.55,Math.max(-1.55,pitch+dy*0.005));
  }});
canvas.addEventListener("wheel",e=>{e.preventDefault();
  dist*=Math.exp(e.deltaY*0.001);
  dist=Math.min(radius0*30,Math.max(radius0*0.01,dist));},{passive:false});
window.addEventListener("keydown",e=>{
  if(e.key==="+"||e.key==="=")psize=Math.min(8,psize+0.5);
  if(e.key==="-")psize=Math.max(0.5,psize-0.5);
  if(e.key==="t")showTraj=!showTraj;
  if(e.key==="r"){yaw=0.8;pitch=0.5;dist=radius0*1.4;tgt=center.slice();}});

requestAnimationFrame(draw);
</script></body></html>
"""
