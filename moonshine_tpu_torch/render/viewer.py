"""Interactive progressive viewer, the `online` frontend's analogue (port
of moonshine_tpu/render/viewer.py; parity: online/main.zig:73-435). A
headless host gets:

  * `Viewer` — progressive accumulate + fly camera (WASD forward/strafe,
    R/F up/down, Q/E yaw — online/main.zig:442-483 key map; any camera move
    restarts accumulation like the reference's sensor reset)
  * `Viewer.run_web()` — a zero-dependency stdlib HTTP viewer: browser shows
    the live tonemapped frame, forwards keystrokes, displays sample count +
    frame time (the ImGui metrics-panel analogue)
  * `Viewer.screenshot()` — tonemapped PNG (io/png.py's encoder, since
    the card's host has no PIL)

Scene edits go through the wrapped Engine as the reference's GUI does
(material/transform edits + pipeline rebuild).
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import replace

import numpy as np

from ..engine import Engine
from ..io.png import encode_png
from ..scene.types import Lens


def tonemap(linear: np.ndarray, exposure: float = 1.0) -> np.ndarray:
    """Linear HDR -> sRGB u8 (the reference blits to an sRGB swapchain)."""
    c = np.clip(linear[..., :3] * exposure, 0.0, 1.0)
    srgb = np.where(c <= 0.0031308, c * 12.92, 1.055 * c ** (1 / 2.4) - 0.055)
    return (srgb * 255.0 + 0.5).astype(np.uint8)


class Viewer:
    MOVE_SPEED = 0.25
    TURN_SPEED = 0.1
    # background render loop pauses when no client has polled for this long
    # (a forgotten browser tab must not keep the device busy forever)
    IDLE_TIMEOUT = 10.0

    def __init__(self, engine: Engine, lens: Lens, width=512, height=512,
                 mesh=None):
        """mesh: optional device mesh — a parallel.Mesh, a spec string
        ('auto' / 'SP,DP'), or None (one device). Passed through to
        Engine.set_mesh, so interactive frames render via
        parallel.render_sharded when height/spp divide the mesh axes."""
        self.engine = engine
        self.width = width
        self.height = height
        self.lens = lens
        if mesh is not None:
            engine.set_mesh(mesh)
        self.sensor = engine.create_sensor(width, height)
        self.lens_handle = engine.create_lens(lens)
        self.exposure = 1.0
        # default accumulation cap (GUI max-samples control); 0 = unbounded.
        # A converged frame stops using the device; any camera move or
        # reset() restarts accumulation from zero.
        self.max_samples = 4096
        self._last_poll = time.time()
        self._stop = threading.Event()
        self._server = None
        self.port = None

    # --- camera fly controls (online/main.zig:442-483) ---

    def _basis(self):
        f = self.lens.forward / np.linalg.norm(self.lens.forward)
        up = self.lens.up / np.linalg.norm(self.lens.up)
        right = np.cross(f, up)
        right /= np.linalg.norm(right)
        return f, up, right

    def handle_key(self, key: str):
        f, up, right = self._basis()
        moved = True
        o = np.asarray(self.lens.origin, np.float32)
        if key == "w":
            o = o + f * self.MOVE_SPEED
        elif key == "s":
            o = o - f * self.MOVE_SPEED
        elif key == "a":
            o = o - right * self.MOVE_SPEED
        elif key == "d":
            o = o + right * self.MOVE_SPEED
        elif key == "r":
            o = o + up * self.MOVE_SPEED
        elif key == "f":
            o = o - up * self.MOVE_SPEED
        elif key in ("q", "e"):
            ang = self.TURN_SPEED if key == "q" else -self.TURN_SPEED
            c, s = np.cos(ang), np.sin(ang)
            new_f = f * c + np.cross(up, f) * s + up * np.dot(up, f) * (1 - c)
            self.lens = Lens(
                origin=o, forward=new_f.astype(np.float32), up=self.lens.up,
                vfov=self.lens.vfov, aperture=self.lens.aperture,
                focus_distance=self.lens.focus_distance,
            )
            moved = True
            self._apply_lens()
            return
        elif key == "0":
            self.reset()
            return
        else:
            moved = False
        if moved:
            self.lens = Lens(
                origin=o.astype(np.float32), forward=self.lens.forward,
                up=self.lens.up, vfov=self.lens.vfov,
                aperture=self.lens.aperture,
                focus_distance=self.lens.focus_distance,
            )
            self._apply_lens()

    def _apply_lens(self):
        self.engine.set_lens(self.lens_handle, self.lens)
        self.reset()  # camera moved -> restart accumulation

    def reset(self):
        self.engine.reset_sensor(self.sensor)

    # --- frame loop ---

    def step(self, wait: bool = True):
        """One 1-spp accumulate; returns the running-mean RGBA frame.

        wait=False returns without reading the frame back (Engine.render)
        — the Display double-buffer analogue (Display.zig:14-28); frame_png
        serves whatever has finished accumulating."""
        if self.max_samples and (
            self.engine.sample_count(self.sensor) >= self.max_samples
        ):
            return self.engine.get_sensor_data(self.sensor)
        # on a device mesh, one interactive frame traces sp samples (one
        # per sample shard) so spp divides the mesh's sample axis and the
        # frame renders via parallel.render_sharded
        mesh = getattr(self.engine, "_mesh", None)
        spp = mesh.shape["sp"] if mesh is not None else 1
        return self.engine.render(self.sensor, self.lens_handle, spp=spp,
                                  wait=wait)

    def frame_png(self) -> bytes:
        return encode_png(
            tonemap(self.engine.get_sensor_data(self.sensor), self.exposure))

    def screenshot(self, path):
        with open(path, "wb") as f:
            f.write(self.frame_png())

    def status(self) -> dict:
        m = self.engine.metrics
        cfg = self.engine.config
        mesh = getattr(self.engine, "_mesh", None)
        return {
            "samples": self.engine.sample_count(self.sensor),
            "mesh": (None if mesh is None
                     else {"sp": mesh.shape["sp"], "dp": mesh.shape["dp"]}),
            "last_frame_seconds": m.get("last_frame_seconds", 0.0),
            "mrays_per_sec": m.get("last_mrays_per_sec", 0.0),
            "origin": np.asarray(self.lens.origin).tolist(),
            "config": {
                "max_bounces": cfg.max_bounces,
                "env_samples_per_bounce": cfg.env_samples_per_bounce,
                "mesh_samples_per_bounce": cfg.mesh_samples_per_bounce,
            },
            "pick": self._pick_info,
        }

    # --- edit panel (online/main.zig:154-285: click-inspection panel with
    # live material/transform edits + the spec-constant editor) ---

    _pick_info: dict | None = None

    def pick(self, u: float, v: float) -> dict:
        """Click-to-inspect at fractional image coords (u right, v down).
        Returns and remembers {instance, geometry, primitive, material,
        visible} — the SyncCopier click-inspection analogue."""
        x = int(np.clip(u, 0, 1) * (self.width - 1))
        y = int(np.clip(v, 0, 1) * (self.height - 1))
        res = self.engine.pick(self.lens_handle, self.width, self.height,
                               x, y)
        if not res.hit:
            self._pick_info = None
            return {"hit": False}
        inst = self.engine.world.instances[res.instance]
        material = int(inst.geometries[res.geometry].material)
        self._pick_info = {
            "hit": True,
            "instance": res.instance,
            "geometry": res.geometry,
            "primitive": res.primitive,
            "material": material,
            "visible": bool(inst.visible),
            "translation": np.asarray(inst.transform, np.float32)[:, 3]
            .tolist(),
        }
        return self._pick_info

    def edit_material(self, updates: dict):
        """Live-edit the picked material. updates keys: color / emissive
        ([r,g,b]), metalness / roughness / ior (float). Value edits create
        solid textures, matching the engine's image-handle surface
        (hydra.zig SetMaterial*)."""
        if not self._pick_info:
            return
        h = self._pick_info["material"]
        e = self.engine
        if "color" in updates:
            e.set_material_color(h, e.create_solid_texture(updates["color"]))
        if "emissive" in updates:
            e.set_material_emissive(
                h, e.create_solid_texture(updates["emissive"]))
        if "metalness" in updates:
            e.set_material_metalness(
                h, e.create_solid_texture(float(updates["metalness"])))
        if "roughness" in updates:
            e.set_material_roughness(
                h, e.create_solid_texture(float(updates["roughness"])))
        if "ior" in updates:
            e.set_material_ior(h, float(updates["ior"]))
        self.reset()

    def edit_transform(self, delta: list):
        """Translate the picked instance by (dx, dy, dz) — a refit, not a
        rebuild (Accel.recordUpdateSingleTransform analogue)."""
        if not self._pick_info:
            return
        i = self._pick_info["instance"]
        t = np.asarray(self.engine.world.instances[i].transform,
                       np.float32).copy()
        t[:, 3] += np.asarray(delta, np.float32)
        self.engine.set_instance_transform(i, t)
        self._pick_info["translation"] = t[:, 3].tolist()
        self.reset()

    def edit_visibility(self, visible: bool):
        if not self._pick_info:
            return
        self.engine.set_instance_visibility(self._pick_info["instance"],
                                            visible)
        self._pick_info["visible"] = visible
        self.reset()

    def edit_config(self, updates: dict):
        """Spec-constant editor + Rebuild button: the new knobs take
        effect from the next frame, the reference's live pipeline rebuild
        (online/main.zig:196-208)."""
        cfg = self.engine.config
        self.engine.set_config(replace(
            cfg,
            max_bounces=int(updates.get("max_bounces", cfg.max_bounces)),
            env_samples_per_bounce=int(updates.get(
                "env_samples_per_bounce", cfg.env_samples_per_bounce)),
            mesh_samples_per_bounce=int(updates.get(
                "mesh_samples_per_bounce", cfg.mesh_samples_per_bounce)),
        ))
        self.reset()

    # --- web frontend ---

    def run_web(self, port: int = 8000, host: str = "127.0.0.1",
                background_render: bool = True):
        """Serve the live view; blocks until `stop()`. Keys are forwarded
        from the browser. port=0 binds a free port (then in self.port)."""
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        viewer = self

        if background_render:
            def loop():
                n = 0
                while not viewer._stop.is_set():
                    idle = (
                        time.time() - viewer._last_poll > viewer.IDLE_TIMEOUT
                    )
                    done = viewer.max_samples and (
                        viewer.engine.sample_count(viewer.sensor)
                        >= viewer.max_samples
                    )
                    if idle or done:
                        time.sleep(0.25)
                        continue
                    # frames-in-flight pipelining: queue asynchronously,
                    # syncing every 4th frame to bound the device queue
                    n += 1
                    viewer.step(wait=(n % 4 == 0))

            threading.Thread(target=loop, daemon=True).start()

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _send(self, code, body, ctype):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                viewer._last_poll = time.time()
                if self.path == "/":
                    self._send(200, _INDEX_HTML.encode(), "text/html")
                elif self.path.startswith("/frame.png"):
                    self._send(200, viewer.frame_png(), "image/png")
                elif self.path == "/status":
                    self._send(
                        200, json.dumps(viewer.status()).encode(),
                        "application/json",
                    )
                else:
                    self._send(404, b"not found", "text/plain")

            def _body_json(self):
                n = int(self.headers.get("Content-Length", 0))
                return json.loads(self.rfile.read(n) or b"{}")

            def do_POST(self):
                if self.path.startswith("/key/"):
                    viewer.handle_key(self.path.rsplit("/", 1)[-1])
                    self._send(200, b"ok", "text/plain")
                elif self.path == "/pick":
                    b = self._body_json()
                    info = viewer.pick(float(b["u"]), float(b["v"]))
                    self._send(200, json.dumps(info).encode(),
                               "application/json")
                elif self.path == "/edit/material":
                    viewer.edit_material(self._body_json())
                    self._send(200, b"ok", "text/plain")
                elif self.path == "/edit/transform":
                    viewer.edit_transform(self._body_json()["delta"])
                    self._send(200, b"ok", "text/plain")
                elif self.path == "/edit/visibility":
                    viewer.edit_visibility(
                        bool(self._body_json()["visible"]))
                    self._send(200, b"ok", "text/plain")
                elif self.path == "/config":
                    viewer.edit_config(self._body_json())
                    self._send(200, b"ok", "text/plain")
                else:
                    self._send(404, b"not found", "text/plain")

        server = ThreadingHTTPServer((host, port), Handler)
        self._server = server
        self.port = server.server_address[1]  # the bound one, for port=0
        try:
            server.serve_forever()
        finally:
            viewer._stop.set()
            server.server_close()

    def stop(self):
        """End run_web (from another thread) and its render loop."""
        self._stop.set()
        if self._server is not None:
            self._server.shutdown()


_INDEX_HTML = """<!doctype html>
<title>moonshine_tpu_torch</title>
<style>
body{background:#111;color:#ccc;font-family:monospace}
#row{display:flex;gap:12px}#panel{min-width:300px;text-align:left}
input{width:60px;background:#222;color:#ccc;border:1px solid #444}
button{background:#333;color:#ccc;border:1px solid #555;cursor:pointer}
fieldset{border:1px solid #333;margin-bottom:8px}
</style>
<h3>moonshine_tpu_torch — WASD move, R/F up/down, Q/E turn, 0 reset; click to inspect</h3>
<div id=row>
<div><img id=v width=640><div id=s></div></div>
<div id=panel>
<fieldset><legend>pick</legend><div id=pick>click the image</div>
 <div id=edits style="display:none">
  color <input id=mc type=color value="#808080"><br>
  metal <input id=mm value=0> rough <input id=mr value=1>
  ior <input id=mi value=1.5><br>
  emissive <input id=me value=0><br>
  <button onclick="mat()">apply material</button><br>
  move <button onclick="mv(1,0,0)">+x</button><button onclick="mv(-1,0,0)">-x</button>
  <button onclick="mv(0,1,0)">+y</button><button onclick="mv(0,-1,0)">-y</button>
  <button onclick="mv(0,0,1)">+z</button><button onclick="mv(0,0,-1)">-z</button><br>
  visible <input id=vis type=checkbox checked onchange="visi()">
 </div></fieldset>
<fieldset><legend>pipeline (rebuild)</legend>
 bounces <input id=cb value=4> env <input id=ce value=1>
 mesh <input id=cm value=1>
 <button onclick="cfg()">Rebuild</button></fieldset>
</div></div>
<script>
const img=document.getElementById('v'), st=document.getElementById('s');
const post=(p,b)=>fetch(p,{method:'POST',body:JSON.stringify(b||{})});
function tick(){img.src='/frame.png?'+Date.now();
 fetch('/status').then(r=>r.json()).then(j=>{
  st.textContent=`samples ${j.samples} | frame ${(j.last_frame_seconds*1e3).toFixed(0)}ms | ${j.mrays_per_sec.toFixed(2)} Mrays/s`;
  document.getElementById('cb').placeholder=j.config.max_bounces;});}
setInterval(tick, 500); tick();
document.addEventListener('keydown', e=>{
 if(document.activeElement.tagName!=='INPUT') post('/key/'+e.key);});
img.onclick=e=>{const r=img.getBoundingClientRect();
 post('/pick',{u:(e.clientX-r.left)/r.width, v:(e.clientY-r.top)/r.height})
 .then(r=>r.json()).then(j=>{
  const p=document.getElementById('pick'), ed=document.getElementById('edits');
  if(!j.hit){p.textContent='miss';ed.style.display='none';return;}
  p.textContent=`instance ${j.instance} geo ${j.geometry} prim ${j.primitive} mat ${j.material} @ [${j.translation.map(x=>x.toFixed(2))}]`;
  document.getElementById('vis').checked=j.visible;
  ed.style.display='block';});};
function hex2rgb(h){return [1,3,5].map(i=>parseInt(h.substr(i,2),16)/255);}
function mat(){post('/edit/material',{
 color:hex2rgb(document.getElementById('mc').value),
 metalness:+document.getElementById('mm').value,
 roughness:+document.getElementById('mr').value,
 ior:+document.getElementById('mi').value,
 emissive:Array(3).fill(+document.getElementById('me').value)});}
function mv(x,y,z){post('/edit/transform',{delta:[x*0.5,y*0.5,z*0.5]});}
function visi(){post('/edit/visibility',{visible:document.getElementById('vis').checked});}
function cfg(){post('/config',{
 max_bounces:+document.getElementById('cb').value,
 env_samples_per_bounce:+document.getElementById('ce').value,
 mesh_samples_per_bounce:+document.getElementById('cm').value});}
</script>"""
