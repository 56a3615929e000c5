"""Live web viewer for online mapping.

The port's own copy of ``nerf_vo_tpu/runtime/viewer.py``, the replacement
for the reference's viser/nerfstudio viewer (reference
nerf_vo/mapping/nerfstudio.py:101-102,125-137, which starts a
``ViewerState`` websocket server and feeds it the training pipeline): a
zero-dependency stdlib HTTP server serving an embedded single-page orbit
viewer. The browser POSTs a requested camera, and the *mapping stage* (the
only thread that launches device work) polls it between train steps and
publishes low-resolution renders back — no second thread ever touches the
device, so training determinism and launch order are untouched.

Endpoints:
  GET  /            the embedded HTML/JS orbit viewer
  GET  /api/state   JSON: step/loss/psnr, keyframe poses (OpenGL c2w)
  GET  /render.jpg  latest published RGB render
  GET  /depth.jpg   latest published depth render
  POST /api/camera  {"c2w": [12 floats, row-major 3x4 OpenGL]} -> requested view
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

import numpy as np

_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>nerf-vo-tpu viewer</title>
<style>
 body{margin:0;background:#111;color:#ddd;font:13px monospace;display:flex}
 #side{width:230px;padding:10px}
 #view{flex:1;display:flex;align-items:center;justify-content:center}
 canvas{background:#000;max-width:100%;max-height:100vh}
 .m{margin:4px 0} b{color:#8cf}
 #help{color:#777;margin-top:12px;line-height:1.5}
</style></head><body>
<div id="side">
 <h3>nerf-vo-tpu</h3>
 <div class="m">step <b id="step">-</b></div>
 <div class="m">loss <b id="loss">-</b></div>
 <div class="m">psnr <b id="psnr">-</b></div>
 <div class="m">keyframes <b id="kf">-</b></div>
 <div class="m">mode <b id="mode">follow</b></div>
 <div id="help">drag: orbit<br>wheel: dolly<br>shift-drag: pan<br>
 f: follow latest keyframe<br>d: toggle rgb/depth</div>
</div>
<div id="view"><canvas id="c" width="640" height="480"></canvas></div>
<script>
const cv=document.getElementById('c'),ctx=cv.getContext('2d');
let az=0,el=0.3,rad=2.5,ctr=[0,0,0],follow=true,depth=false,poses=[];
function c2w(){ // OpenGL: camera -Z looks at ctr, +Y up-ish
 const ce=Math.cos(el),se=Math.sin(el),ca=Math.cos(az),sa=Math.sin(az);
 const eye=[ctr[0]+rad*ce*sa,ctr[1]+rad*se,ctr[2]+rad*ce*ca];
 let z=[eye[0]-ctr[0],eye[1]-ctr[1],eye[2]-ctr[2]];
 const nz=Math.hypot(...z); z=z.map(v=>v/nz);
 const up=[0,1,0];
 let x=[up[1]*z[2]-up[2]*z[1],up[2]*z[0]-up[0]*z[2],up[0]*z[1]-up[1]*z[0]];
 const nx=Math.hypot(...x)||1; x=x.map(v=>v/nx);
 const y=[z[1]*x[2]-z[2]*x[1],z[2]*x[0]-z[0]*x[2],z[0]*x[1]-z[1]*x[0]];
 return [x[0],y[0],z[0],eye[0], x[1],y[1],z[1],eye[1], x[2],y[2],z[2],eye[2]];
}
let drag=null;
cv.onmousedown=e=>{drag=[e.clientX,e.clientY,e.shiftKey];};
window.onmouseup=()=>{drag=null;};
window.onmousemove=e=>{if(!drag)return;follow=false;
 const dx=e.clientX-drag[0],dy=e.clientY-drag[1];
 if(drag[2]){const s=rad*0.002;
  const m=c2w();ctr[0]-=m[0]*dx*s-m[1]*dy*s;ctr[1]-=m[4]*dx*s-m[5]*dy*s;
  ctr[2]-=m[8]*dx*s-m[9]*dy*s;}
 else{az-=dx*0.008;el=Math.max(-1.5,Math.min(1.5,el+dy*0.008));}
 drag=[e.clientX,e.clientY,drag[2]];sendCam();};
cv.onwheel=e=>{follow=false;rad*=Math.exp(e.deltaY*0.001);sendCam();e.preventDefault();};
window.onkeydown=e=>{if(e.key=='f'){follow=true;}if(e.key=='d'){depth=!depth;}};
let sendT=0;
function sendCam(){document.getElementById('mode').textContent='orbit';
 const now=Date.now();if(now-sendT<100)return;sendT=now;
 fetch('/api/camera',{method:'POST',body:JSON.stringify({c2w:c2w()})});}
async function tick(){
 try{
  const s=await (await fetch('/api/state')).json();
  for(const k of ['step','loss','psnr'])
   document.getElementById(k).textContent=
    typeof s[k]=='number'?s[k].toPrecision(4):'-';
  document.getElementById('kf').textContent=s.num_keyframes;
  poses=s.poses||[];
  if(follow){document.getElementById('mode').textContent='follow';
   if(poses.length){const p=poses[poses.length-1];
    ctr=[p[3],p[7],p[11]];}
   fetch('/api/camera',{method:'POST',body:JSON.stringify({follow:true})});}
  const img=new Image();
  img.onload=()=>{cv.width=img.width*2;cv.height=img.height*2;
   ctx.imageSmoothingEnabled=false;ctx.drawImage(img,0,0,cv.width,cv.height);};
  img.src=(depth?'/depth.jpg?':'/render.jpg?')+Date.now();
 }catch(e){}
 setTimeout(tick,500);
}
tick();
</script></body></html>"""


class LiveViewer:
    """Thread-safe mailbox between the HTTP thread and the mapping stage."""

    def __init__(self, port: int = 7007):
        self._lock = threading.Lock()
        self._rgb_jpeg: Optional[bytes] = None
        self._depth_jpeg: Optional[bytes] = None
        self._stats: Dict = {}
        self._poses: list = []
        self._camera: Optional[np.ndarray] = None  # [4,4] OpenGL c2w or None
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self.port = port

    # -- mapping-stage side (the only thread that launches device work) --

    def publish(self, rgb_jpeg: bytes, depth_jpeg: bytes,
                stats: Dict, poses: np.ndarray) -> None:
        """Store the latest render + scalars. ``poses``: [K, 4, 4] OpenGL."""
        flat = [
            [float(v) for v in p[:3].reshape(-1)] for p in np.asarray(poses)
        ]
        with self._lock:
            self._rgb_jpeg = rgb_jpeg
            self._depth_jpeg = depth_jpeg
            self._stats = {k: float(v) for k, v in stats.items()}
            self._poses = flat

    def requested_camera(self) -> Optional[np.ndarray]:
        """[4,4] OpenGL c2w the browser wants, or None for follow mode."""
        with self._lock:
            return None if self._camera is None else self._camera.copy()

    # -- HTTP side ---------------------------------------------------------

    def _set_camera(self, body: dict) -> None:
        with self._lock:
            if body.get("follow"):
                self._camera = None
            elif "c2w" in body:
                m = np.eye(4, dtype=np.float32)
                m[:3] = np.asarray(body["c2w"], np.float32).reshape(3, 4)
                self._camera = m

    def _state_json(self) -> bytes:
        with self._lock:
            return json.dumps(
                dict(self._stats, num_keyframes=len(self._poses),
                     poses=self._poses)
            ).encode()

    def _jpeg(self, which: str) -> Optional[bytes]:
        with self._lock:
            return self._rgb_jpeg if which == "rgb" else self._depth_jpeg

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> int:
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # silence per-request stderr spam
                pass

            def _send(self, code, ctype, body):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?")[0]
                if path == "/":
                    self._send(200, "text/html", _PAGE.encode())
                elif path == "/api/state":
                    self._send(200, "application/json", viewer._state_json())
                elif path in ("/render.jpg", "/depth.jpg"):
                    img = viewer._jpeg(
                        "rgb" if path == "/render.jpg" else "depth"
                    )
                    if img is None:
                        self._send(404, "text/plain", b"no render yet")
                    else:
                        self._send(200, "image/jpeg", img)
                else:
                    self._send(404, "text/plain", b"not found")

            def do_POST(self):
                if self.path.split("?")[0] == "/api/camera":
                    n = int(self.headers.get("Content-Length", 0))
                    try:
                        viewer._set_camera(json.loads(self.rfile.read(n)))
                        self._send(200, "application/json", b"{}")
                    except (ValueError, KeyError):
                        self._send(400, "text/plain", b"bad camera")
                else:
                    self._send(404, "text/plain", b"not found")

        self._server = ThreadingHTTPServer(("0.0.0.0", self.port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )
        self._thread.start()
        print(f"[viewer] live at http://localhost:{self.port}", flush=True)
        return self.port

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
