"""WebDisplay — browser-based interactive viewer + settings panel.

The reference's display layer is a GLFW/OpenGL window with an ImGui debug
panel (src/display/Display.cpp:68-239, src/display/glfw/*). A GPU render
server is headless, so the windowing capability is delivered as an
embedded HTTP server streaming the
framebuffer to any browser, with the SAME debug-panel knobs
(``SettingsBinding``) editable live and the same FPS-style camera keys
(src/app/main.cpp:16-248) forwarded to the ``InputHandler``.

Endpoints:
  GET  /           viewer page (frame + knob panel, keyboard forwarded)
  GET  /frame.png  latest frame (client polls; no GPU copy — the frame the
                   render loop handed to draw_frame)
  GET  /knobs      JSON rows of (label, key, kind, extra, value)
  POST /set        {"key": ..., "value": ...} -> settings write-through
  POST /key        {"key": "w"} -> InputHandler.key_press (camera)
  POST /quit       window_should_close() -> True (ends the render loop)

Zero third-party server dependencies: http.server from the stdlib, one
daemon thread, lock-guarded latest-frame buffer; frames are PNG-coded by
utils/image.py:encode_png (zlib alone, no PIL). A copy of the JAX package's
strelka_tpu/display/web.py.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from strelka_tpu_torch import log
from strelka_tpu_torch.display.display import Display, SettingsBinding
from strelka_tpu_torch.render.buffer import ImageBuffer

_PAGE = """<!doctype html>
<html><head><title>strelka_tpu_torch</title><style>
body{background:#141414;color:#ddd;font:13px monospace;margin:0;display:flex}
#view{flex:1;text-align:center;padding:8px}
#panel{width:340px;padding:12px;background:#1d1d1d;overflow-y:auto}
img{max-width:100%;image-rendering:pixelated;outline:1px solid #333}
.knob{margin:6px 0}label{display:inline-block;width:170px}
input,select{background:#2a2a2a;color:#ddd;border:1px solid #444;width:140px}
h3{margin:4px 0 10px}</style></head><body>
<div id=view><img id=frame src=/frame.png></div>
<div id=panel><h3>debug panel</h3><div id=knobs></div>
<p>camera: WASD/QE + arrows (focus the page)</p></div>
<script>
const img=document.getElementById('frame');
setInterval(()=>{img.src='/frame.png?t='+Date.now();},250);
async function loadKnobs(){
  const rows=await (await fetch('/knobs')).json();
  const div=document.getElementById('knobs');div.innerHTML='';
  for(const [label,key,kind,extra,value] of rows){
    const w=document.createElement('div');w.className='knob';
    let inp;
    if(kind==='combo'){inp=document.createElement('select');
      extra.forEach((name,i)=>{const o=document.createElement('option');
        o.value=i;o.text=name;if(i===value)o.selected=true;inp.add(o);});}
    else if(kind==='bool'){inp=document.createElement('input');
      inp.type='checkbox';inp.checked=!!value;}
    else{inp=document.createElement('input');inp.type='number';
      inp.step=kind==='float'?'any':'1';inp.value=value;}
    inp.onchange=()=>{let v=kind==='bool'?(inp.checked?1:0):Number(inp.value);
      fetch('/set',{method:'POST',body:JSON.stringify({key:key,value:v})});};
    const l=document.createElement('label');l.textContent=label;
    w.append(l,inp);div.append(w);}
}
loadKnobs();
document.addEventListener('keydown',e=>{
  fetch('/key',{method:'POST',body:JSON.stringify({key:e.key})});});
</script></body></html>"""


class WebDisplay(Display):
    """Serve the render interactively over HTTP (see module docstring)."""

    def __init__(self, port: int = 8787, host: str = "127.0.0.1"):
        super().__init__()
        self.port = port
        self.host = host
        self._lock = threading.Lock()
        self._png: Optional[bytes] = None
        self.last_frame: Optional[np.ndarray] = None
        self._closed = False
        self._binding: Optional[SettingsBinding] = None
        self._server: Optional[ThreadingHTTPServer] = None

    # -- Display interface ------------------------------------------------
    def init(self, width: int, height: int, ctx) -> None:
        super().init(width, height, ctx)
        if ctx is not None and getattr(ctx, "settings", None) is not None:
            self._binding = SettingsBinding(ctx.settings)
        disp = self

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code, body, ctype="application/json"):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?")[0]
                if path == "/":
                    self._send(200, _PAGE.encode(), "text/html")
                elif path == "/frame.png":
                    png = disp._frame_png()
                    if png is None:
                        self._send(404, b"{}")
                    else:
                        self._send(200, png, "image/png")
                elif path == "/knobs":
                    rows = disp._binding.knobs() if disp._binding else []
                    self._send(200, json.dumps(rows).encode())
                else:
                    self._send(404, b"{}")

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0) or 0)
                try:
                    body = json.loads(self.rfile.read(n) or b"{}")
                except ValueError:
                    self._send(400, b"{}")
                    return
                if self.path == "/set" and disp._binding is not None:
                    disp._binding.set(body["key"], body["value"])
                    self._send(200, b"{}")
                elif self.path == "/key":
                    if disp._input_handler is not None:
                        disp._input_handler.key_press(str(body.get("key", "")), "press")
                    self._send(200, b"{}")
                elif self.path == "/quit":
                    disp._closed = True
                    self._send(200, b"{}")
                else:
                    self._send(404, b"{}")

        self._server = ThreadingHTTPServer((self.host, self.port), _Handler)
        self.port = self._server.server_address[1]  # resolves port 0
        t = threading.Thread(target=self._server.serve_forever, daemon=True)
        t.start()
        log.info("WebDisplay: http://{}:{}/", self.host, self.port)

    def destroy(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None

    def window_should_close(self) -> bool:
        return self._closed

    def draw_frame(self, image: ImageBuffer) -> None:
        arr = np.asarray(image.data)
        with self._lock:
            self.last_frame = arr
            self._png = None  # encode lazily on request

    # -- internals ---------------------------------------------------------
    def _frame_png(self) -> Optional[bytes]:
        from strelka_tpu_torch.utils.image import encode_png

        with self._lock:
            if self._png is not None:
                return self._png
            if self.last_frame is None:
                return None
            arr = self.last_frame
        png = encode_png(arr[..., :3])
        with self._lock:
            self._png = png
        return png
