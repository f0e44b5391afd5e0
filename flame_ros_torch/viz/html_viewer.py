"""Standalone WebGL mesh viewer export.

Counterpart of `flame_ros_tpu/viz/html_viewer.py` (the same page).

Capability parity with the reference rviz plugin (TexturedMeshDisplay /
TexturedMeshVisual, src/flame_rviz_plugins/: GLSL-shaded textured triangle
meshes with four shader modes — TEXTURE, INVERSE_DEPTH, JET, SURFACE_NORMAL
(ShaderProgram enum, textured_mesh_visual.h:64-69, fragment shaders
h:202-387) plus the surface-normals line overlay). Instead of an rviz/OGRE
process, the exporter writes a single self-contained HTML file (no network
dependencies) with embedded vertex/index buffers, the same four shading
modes, an orbit camera, and an optional normals overlay — viewable
anywhere.
"""
from __future__ import annotations

import base64
import json

import numpy as np

_HTML = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>flame mesh</title>
<style>body{margin:0;background:#111;color:#ddd;font-family:monospace}
#hud{position:fixed;top:8px;left:8px}button{margin-right:4px}</style></head>
<body><div id="hud">
<button onclick="setMode(0)">jet</button>
<button onclick="setMode(1)">idepth</button>
<button onclick="setMode(2)">normal</button>
<button onclick="setMode(3)">texture</button>
<button onclick="toggleNormals()">normals overlay</button>
<span id="info"></span></div>
<canvas id="c"></canvas>
<script>
const DATA = __DATA__;
const cv = document.getElementById('c');
cv.width = innerWidth; cv.height = innerHeight;
const gl = cv.getContext('webgl');
const VS = `attribute vec3 p; attribute vec3 n; attribute vec2 t;
uniform mat4 mvp; varying vec3 vp; varying vec3 vn; varying vec2 vt;
void main(){ gl_Position = mvp*vec4(p,1.0); vp=p; vn=n; vt=t; }`;
const FS = `precision mediump float; varying vec3 vp; varying vec3 vn;
varying vec2 vt; uniform int mode; uniform float scale; uniform sampler2D tex;
vec3 jet(float v){ v=clamp(v,0.0,1.0);
 return clamp(vec3(1.5-abs(4.0*v-3.0),1.5-abs(4.0*v-2.0),1.5-abs(4.0*v-1.0)),0.0,1.0);}
void main(){ float xi = scale/max(length(vp),1e-6);
 if(mode==0) gl_FragColor=vec4(jet(xi),1.0);
 else if(mode==1) gl_FragColor=vec4(vec3(clamp(xi,0.0,1.0)),1.0);
 else if(mode==2) gl_FragColor=vec4(vn*0.5+0.5,1.0);
 else gl_FragColor=texture2D(tex,vt); }`;
function sh(type,src){const s=gl.createShader(type);gl.shaderSource(s,src);
gl.compileShader(s);if(!gl.getShaderParameter(s,gl.COMPILE_STATUS))
throw gl.getShaderInfoLog(s);return s;}
const prog = gl.createProgram();
gl.attachShader(prog, sh(gl.VERTEX_SHADER,VS));
gl.attachShader(prog, sh(gl.FRAGMENT_SHADER,FS));
gl.linkProgram(prog); gl.useProgram(prog);
gl.getExtension('OES_element_index_uint');
function attr(name,b,size){const a=gl.getAttribLocation(prog,name);
gl.bindBuffer(gl.ARRAY_BUFFER,b);gl.enableVertexAttribArray(a);
gl.vertexAttribPointer(a,size,gl.FLOAT,false,0,0);}
const tex = gl.createTexture();
gl.bindTexture(gl.TEXTURE_2D, tex);
gl.texImage2D(gl.TEXTURE_2D,0,gl.RGBA,1,1,0,gl.RGBA,gl.UNSIGNED_BYTE,
 new Uint8Array([128,128,128,255]));
// Mutable mesh buffers: setMesh re-uploads everything, so a live
// client can stream growing meshes into the same page (reference
// TexturedMeshVisual updateVertexBuffer/updateIndexBuffer semantics —
// buffers are re-filled per message, the scene persists). The GL
// buffer HANDLES are created once and re-filled with bufferData —
// allocating fresh buffers per update would leak GPU memory over a
// long live session (the old stores stay referenced by the context).
const pb=gl.createBuffer(), nb=gl.createBuffer(), tb=gl.createBuffer(),
 ib=gl.createBuffer(), lpb=gl.createBuffer(), lnb=gl.createBuffer(),
 ltb=gl.createBuffer();
function refill(target,b,data){gl.bindBuffer(target,b);
 gl.bufferData(target,data,gl.STATIC_DRAW);}
let xyz,nrm,uv,idx,nverts=0;
function setMesh(D){
 xyz = new Float32Array(D.xyz);
 nrm = new Float32Array(D.normals);
 uv = new Float32Array(D.uv);
 idx = new Uint32Array(D.tris);
 refill(gl.ARRAY_BUFFER,pb,xyz); refill(gl.ARRAY_BUFFER,nb,nrm);
 refill(gl.ARRAY_BUFFER,tb,uv); refill(gl.ELEMENT_ARRAY_BUFFER,ib,idx);
 DATA.center=D.center; DATA.scale=D.scale;
 if (D.texture_png){ const im=new Image();
  im.onload=()=>{gl.bindTexture(gl.TEXTURE_2D,tex);
  gl.texImage2D(gl.TEXTURE_2D,0,gl.RGBA,gl.RGBA,gl.UNSIGNED_BYTE,im);
  gl.texParameteri(gl.TEXTURE_2D,gl.TEXTURE_MIN_FILTER,gl.LINEAR);
  gl.texParameteri(gl.TEXTURE_2D,gl.TEXTURE_WRAP_S,gl.CLAMP_TO_EDGE);
  gl.texParameteri(gl.TEXTURE_2D,gl.TEXTURE_WRAP_T,gl.CLAMP_TO_EDGE);};
  im.src='data:image/png;base64,'+D.texture_png; }
 // Surface-normal line overlay (reference SurfaceNormalsVisual line
 // list): each vertex contributes a segment [p, p + len*n].
 const nlen = DATA.scale*0.03;
 nverts = xyz.length/3;
 const lpos = new Float32Array(nverts*6), lnrm = new Float32Array(nverts*6),
  luv = new Float32Array(nverts*4);
 for(let i=0;i<nverts;i++){
  for(let k=0;k<3;k++){ lpos[6*i+k]=xyz[3*i+k];
   lpos[6*i+3+k]=xyz[3*i+k]+nlen*nrm[3*i+k];
   lnrm[6*i+k]=nrm[3*i+k]; lnrm[6*i+3+k]=nrm[3*i+k]; } }
 refill(gl.ARRAY_BUFFER,lpb,lpos); refill(gl.ARRAY_BUFFER,lnb,lnrm);
 refill(gl.ARRAY_BUFFER,ltb,luv);
}
setMesh(DATA);
let mode=0, showNormals=false, rotX=0, rotY=0, dist=3.0;
function setMode(m){mode=m;} function toggleNormals(){showNormals=!showNormals;}
cv.onmousedown=e=>{let lx=e.clientX,ly=e.clientY;
 cv.onmousemove=e2=>{rotY+=(e2.clientX-lx)*0.005;rotX+=(e2.clientY-ly)*0.005;
 lx=e2.clientX;ly=e2.clientY;};cv.onmouseup=()=>cv.onmousemove=null;};
cv.onwheel=e=>{dist*=Math.exp(e.deltaY*0.001);e.preventDefault();};
function mat(){const a=cv.width/cv.height,f=1.5,zn=0.05,zf=100.0;
const P=[f/a,0,0,0, 0,f,0,0, 0,0,(zf+zn)/(zn-zf),-1, 0,0,2*zf*zn/(zn-zf),0];
const cx=Math.cos(rotX),sx=Math.sin(rotX),cy=Math.cos(rotY),sy=Math.sin(rotY);
const c=DATA.center;
const R=[cy,sx*sy,-cx*sy,0, 0,cx,sx,0, sy,-sx*cy,cx*cy,0, 0,0,0,1];
const T=[1,0,0,0, 0,1,0,0, 0,0,1,0, -c[0],-c[1],-c[2],1];
const Z=[1,0,0,0, 0,1,0,0, 0,0,1,0, 0,0,-dist,1];
return mul(P,mul(Z,mul(R,T)));}
function mul(A,B){const O=new Array(16).fill(0);
for(let i=0;i<4;i++)for(let j=0;j<4;j++)for(let k=0;k<4;k++)
O[j*4+i]+=A[k*4+i]*B[j*4+k];return O;}
function draw(){
 gl.viewport(0,0,cv.width,cv.height);
 gl.clearColor(0.06,0.06,0.08,1); gl.enable(gl.DEPTH_TEST);
 gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT);
 gl.uniformMatrix4fv(gl.getUniformLocation(prog,'mvp'),false,new Float32Array(mat()));
 gl.uniform1f(gl.getUniformLocation(prog,'scale'),DATA.scale);
 attr('p',pb,3); attr('n',nb,3); attr('t',tb,2);
 gl.uniform1i(gl.getUniformLocation(prog,'mode'),mode);
 gl.bindBuffer(gl.ELEMENT_ARRAY_BUFFER,ib);
 gl.drawElements(gl.TRIANGLES,idx.length,gl.UNSIGNED_INT,0);
 if(showNormals){
  attr('p',lpb,3); attr('n',lnb,3); attr('t',ltb,2);
  gl.uniform1i(gl.getUniformLocation(prog,'mode'),2);
  gl.drawArrays(gl.LINES,0,nverts*2);
 }
 document.getElementById('info').textContent =
  ` ${xyz.length/3} verts, ${idx.length/3} tris` + (window.LIVE_STATUS||'');
 requestAnimationFrame(draw);}
draw();
__LIVE_SCRIPT__
</script></body></html>
"""

# Polling loop injected in place of __LIVE_SCRIPT__ by the live viewer
# (viz/live_viewer.py): fetch the latest mesh JSON and re-upload the
# buffers — the reference demo's "watch the mesh grow while the system
# runs" UX (TexturedMeshDisplay processes a continuous mesh topic,
# textured_mesh_display.cc:389-503).
_LIVE_SCRIPT = """
window.LIVE_STATUS = ' | live: connecting';
let lastStamp = -1;
async function poll(){
 try{
  const r = await fetch('mesh.json?since='+lastStamp);
  if (r.status === 200){
   const D = await r.json();
   if (D.stamp !== lastStamp){ lastStamp = D.stamp; setMesh(D); }
   window.LIVE_STATUS = ' | live: frame '+D.img_id;
  }
 } catch(e){ window.LIVE_STATUS = ' | live: disconnected'; }
 setTimeout(poll, __PERIOD_MS__);
}
poll();
"""


def mesh_viewer_data(vertices_px, idepths, normals, tris, tri_keep, K, *,
                     gray: np.ndarray = None,
                     scale: float = None) -> dict:
    """Backproject a pixel-space mesh into the viewer's JSON buffer
    layout (shared by the static export and the live poller)."""
    from flame_ros_torch.viz.export import backproject_mesh

    keep = np.asarray(tri_keep, bool)
    faces = np.asarray(tris)[keep]
    xyz, uv = backproject_mesh(np.asarray(vertices_px),
                               np.asarray(idepths), K,
                               gray.shape[1] if gray is not None else None,
                               gray.shape[0] if gray is not None else None)
    center = xyz.mean(0) if len(xyz) else np.zeros(3)
    if scale is None:
        med = np.median(np.linalg.norm(xyz, axis=1)) if len(xyz) else 1.0
        scale = float(med)
    tex_png = None
    if gray is not None:
        import cv2
        ok, enc = cv2.imencode(".png",
                               np.clip(gray, 0, 255).astype(np.uint8))
        if ok:
            tex_png = base64.b64encode(enc.tobytes()).decode()
    return {
        "xyz": np.asarray(xyz, np.float32).ravel().tolist(),
        "normals": np.asarray(normals, np.float32).ravel().tolist(),
        "uv": np.asarray(uv, np.float32).ravel().tolist(),
        "tris": np.asarray(faces, np.int64).ravel().tolist(),
        "center": [float(x) for x in center],
        "scale": scale,
        "texture_png": tex_png,
    }


def render_page(data: dict, live_period_ms: int = 0) -> str:
    """Render the viewer HTML: static (live_period_ms=0) or with the
    auto-refresh polling loop baked in."""
    live = (_LIVE_SCRIPT.replace("__PERIOD_MS__", str(live_period_ms))
            if live_period_ms > 0 else "")
    return (_HTML.replace("__DATA__", json.dumps(data))
            .replace("__LIVE_SCRIPT__", live))


def export_html_viewer(path: str, vertices_px, idepths, normals, tris,
                       tri_keep, K, *, gray: np.ndarray = None,
                       scale: float = None):
    """Write a self-contained interactive mesh viewer HTML."""
    data = mesh_viewer_data(vertices_px, idepths, normals, tris,
                            tri_keep, K, gray=gray, scale=scale)
    with open(path, "w") as f:
        f.write(render_page(data))
    return path
