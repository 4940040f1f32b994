"""Live progressive viewer: a local HTTP page over the accumulating film
(mirrors ``mrt.runtime.viewer``).

The reference opens a window that repaints as passes merge, with
runtime keys: 1..5 display modes, E export, backtick quick pass (abort
the render and show the albedo preview).  The same interaction ships as
a small standard-library HTTP server: the browser polls the tonemapped
frame and posts keystrokes; the render loop, in the caller's thread,
polls the shared state between passes and aborts and restarts when a
key asks for it.  The HTTP thread reads only what the render loop
published (PNG bytes, integers, the mode); it never touches a tensor.

Run: ``python -m mrt_torch --scene cornell --serve --port 7860`` and
open http://localhost:7860.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from .. import scenes
from ..core.device import resolve
from .film import DisplayMode, Film
from .input import InputCollection, InputRecorder
from .io import png_encode

_MODES = {
    "1": DisplayMode.DEFAULT,
    "2": DisplayMode.DENOISE,
    "3": DisplayMode.DEPTH,
    "4": DisplayMode.ALBEDO,
    "5": DisplayMode.NORMAL,
}

_PAGE = """<!doctype html>
<html><head><title>mrt live</title><style>
body { background:#111; color:#ddd; font-family:monospace; margin:1em }
img { image-rendering:pixelated; width:min(96vw, 1280px); }
#bar { margin:.5em 0 }
</style></head><body>
<div id="bar">mrt &mdash; keys: 1..5 display modes &middot; E export
&middot; ` quick-pass &middot; WASD+space play (--play scenes)
&middot; <span id="st"></span></div>
<img id="frame" src="/frame.png">
<script>
const img = document.getElementById('frame');
const st = document.getElementById('st');
async function tick() {
  try {
    const r = await fetch('/frame.png?' + Date.now());
    img.src = URL.createObjectURL(await r.blob());
    const s = await (await fetch('/status')).json();
    st.textContent = s.mode + ' | ' + s.samples + ' spp' +
        (s.frame !== undefined ? ' | frame ' + s.frame : '') +
        (s.quick_pass ? ' | QUICK PASS' : '') +
        (s.done ? ' | done' : '');
  } catch (e) {}
  setTimeout(tick, 250);
}
tick();
// Held game keys stream to /input as a comma list (the gilrs
// poll-every-frame role, main.rs:333-360); everything else stays a
// one-shot /key control event.
const held = new Set();
const game = new Set(['w','a','s','d',' ','shift',
                      'arrowleft','arrowright','arrowup','arrowdown']);
function sendHeld() {
  fetch('/input?held=' + encodeURIComponent([...held].join(',')));
}
document.addEventListener('keydown', (e) => {
  const k = e.key.toLowerCase();
  if (game.has(k)) {
    if (!held.has(k)) { held.add(k); sendHeld(); }
    e.preventDefault();
  } else {
    fetch('/key?k=' + encodeURIComponent(e.key));
  }
});
document.addEventListener('keyup', (e) => {
  const k = e.key.toLowerCase();
  if (held.delete(k)) sendHeld();
});
window.addEventListener('blur', () => { held.clear(); sendHeld(); });
setInterval(sendHeld, 400);   // heartbeat vs missed keyups
</script></body></html>
"""


class ViewerState:
    """State shared by the HTTP thread and the render loop, under one
    lock."""

    def __init__(self):
        self.lock = threading.Lock()
        self.mode = DisplayMode.DEFAULT
        self.quick_pass = False
        self.export_requested = False
        self.epoch = 0          # bumped on any abort-worthy change
        self.film = None        # read by the render loop only
        self.samples = 0
        self.done = False
        self.png = b""
        self.held = frozenset()  # live game keys (w/a/s/d/space/...)
        self.frame = None        # play mode's frame counter

    def set_held(self, keys):
        with self.lock:
            self.held = frozenset(k for k in keys if k)

    def input_collection(self):
        """The held keys as the frame's InputCollection."""
        with self.lock:
            h = self.held
        return InputCollection(
            stick_x=(1.0 if "d" in h else 0.0)
                    - (1.0 if "a" in h else 0.0),
            stick_y=(1.0 if "w" in h else 0.0)
                    - (1.0 if "s" in h else 0.0),
            cam_x=(1.0 if "arrowright" in h else 0.0)
                  - (1.0 if "arrowleft" in h else 0.0),
            cam_z=(1.0 if "arrowup" in h else 0.0)
                  - (1.0 if "arrowdown" in h else 0.0),
            button_a=" " in h,
            button_b="shift" in h,
        )

    def key(self, k):
        with self.lock:
            if k in _MODES:
                self.mode = _MODES[k]
            elif k.lower() == "e":
                self.export_requested = True
            elif k == "`":
                self.quick_pass = not self.quick_pass
                self.epoch += 1     # abort and restart

    def publish(self, film, png, samples, done=False):
        with self.lock:
            self.film = film
            self.png = png
            self.samples = samples
            self.done = done

    def snapshot(self):
        with self.lock:
            return (self.mode, self.quick_pass, self.epoch,
                    self.export_requested)

    def clear_export(self):
        with self.lock:
            self.export_requested = False


def _handler(state: ViewerState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):       # quiet
            pass

        def _send(self, code, ctype, body):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            query = parse_qs(urlparse(self.path).query)
            if self.path.startswith("/frame.png"):
                with state.lock:
                    png = state.png
                if not png:
                    self._send(503, "text/plain", b"no frame yet")
                else:
                    self._send(200, "image/png", png)
            elif self.path.startswith("/key"):
                state.key(query.get("k", [""])[0])
                self._send(200, "text/plain", b"ok")
            elif self.path.startswith("/input"):
                held = query.get("held", [""])[0]
                state.set_held(held.split(",") if held else [])
                self._send(200, "text/plain", b"ok")
            elif self.path.startswith("/status"):
                with state.lock:
                    d = dict(
                        mode=state.mode.value, samples=int(state.samples),
                        quick_pass=state.quick_pass,
                        done=state.done)
                    if state.frame is not None:
                        d["frame"] = int(state.frame)
                self._send(200, "application/json", json.dumps(d).encode())
            else:
                self._send(200, "text/html", _PAGE.encode())
    return Handler


def png_bytes(rgb_bottom_up):
    """(H, W, 3) uint8 rows bottom-up -> PNG bytes, rows top-down."""
    return png_encode(rgb_bottom_up)


class _Abort(Exception):
    pass


def serve(config, log=print, stop=None, device=None):
    """Progressive render with the live viewer attached, on `device`
    (None: the CUDA card).

    stop: optional threading.Event; once set, the loop winds down and
    returns, so an embedding process can stop the render thread between
    passes instead of killing it."""
    if stop is None:
        stop = threading.Event()
    from .driver import _denoiser_for
    from .render import aov_pass, render

    device = resolve(device)
    state = ViewerState()
    httpd = ThreadingHTTPServer((config.host, config.port),
                                _handler(state))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    log(f"viewer at http://{config.host}:{config.port}")

    sc = scenes.get(config.scene)(aspect_ratio=config.aspect_ratio,
                                  nee=config.nee)
    denoiser = _denoiser_for(config)
    albedo = normal = None

    def tonemap(film):
        mode, _, _, _ = state.snapshot()
        return film.to_rgb_bytes(mode, denoiser=denoiser)

    if config.play:
        # Play mode generates each frame itself: generating here too
        # would tick stateful scenes (physics) once more and break
        # record/replay bit-identity.
        return _play_loop(config, state, sc, stop, log, tonemap, httpd,
                          device)

    scene, camera = sc.generate(0.0, 0, InputCollection(), device=device)

    try:
        while not stop.is_set():
            mode, quick, epoch, _ = state.snapshot()
            if quick:
                # Quick pass: the albedo preview only.
                if albedo is None:
                    albedo, normal = aov_pass(
                        scene, camera, width=config.width,
                        height=config.height, seed=config.seed)
                film = Film.create(config.width, config.height,
                                   device=device).with_aov(albedo, normal)
                state.publish(film,
                              png_bytes(film.to_rgb_bytes(
                                  DisplayMode.ALBEDO)), 0, done=True)
                while state.snapshot()[2] == epoch and not stop.is_set():
                    self_export(state, film, config)
                    time.sleep(0.2)
                continue

            needs_aov = (config.denoise or denoiser is not None
                         or mode in (DisplayMode.DENOISE,
                                     DisplayMode.ALBEDO,
                                     DisplayMode.NORMAL))

            def progress(f):
                state.publish(f, png_bytes(tonemap(f)), f.samples)
                self_export(state, f, config)
                if state.snapshot()[2] != epoch or stop.is_set():
                    raise _Abort()

            try:
                film = render(scene, camera, config.width, config.height,
                              spp=config.spp, seed=config.seed,
                              max_depth=config.max_depth,
                              samples_per_pass=config.samples_per_pass,
                              with_aov=needs_aov, progress=progress,
                              persistent=config.persistent,
                              rr_depth=config.rr_depth)
            except _Abort:
                continue
            state.publish(film, png_bytes(tonemap(film)), film.samples,
                          done=True)
            log(f"render complete at {film.samples} spp; viewer stays live "
                "(Ctrl-C to quit)")
            while state.snapshot()[2] == epoch and not stop.is_set():
                state.publish(film, png_bytes(tonemap(film)), film.samples,
                              done=True)
                self_export(state, film, config)
                time.sleep(0.4)
    except KeyboardInterrupt:
        log("viewer stopped")
    finally:
        httpd.shutdown()
        httpd.server_close()


def _play_loop(config, state, sc, stop, log, tonemap, httpd, device):
    """Interactive game loop: the browser's held keys become each frame's
    InputCollection; the scene is generated anew and one short frame
    rendered, again and again.  With write_input the session is
    recorded, and replaying it through the animation driver gives the
    same frames."""
    from .driver import _sync, export, render_frame

    recorder = InputRecorder() if config.write_input else None
    fcfg = dataclasses.replace(config, spp=config.samples_per_frame)
    total = max(config.total_frames, 1)
    frame = 0
    film = None
    log(f"play mode: WASD + space in the browser drive the scene "
        f"({config.samples_per_frame} spp/frame)")
    try:
        while not stop.is_set():
            inp = state.input_collection()
            if recorder is not None:
                recorder.record(inp)
            scene, camera = sc.generate(frame / total, frame, inp,
                                        device=device)
            film = render_frame(scene, camera, fcfg)
            _sync(film)
            with state.lock:
                state.frame = frame
            state.publish(film, png_bytes(tonemap(film)), film.samples)
            self_export(state, film, config)
            frame += 1
    except KeyboardInterrupt:
        log("play loop stopped")
    finally:
        if recorder is not None and recorder.frames:
            recorder.save(config.write_input)
            log(f"recorded {len(recorder.frames)} frames -> "
                f"{config.write_input}")
        if film is not None:
            export(film, config.output, config)  # the last played frame
        httpd.shutdown()
        httpd.server_close()


def self_export(state, film, config):
    """Export the film if the page asked for it (key E)."""
    _, _, _, want_export = state.snapshot()
    if want_export and film is not None:
        from .driver import export

        export(film, config.output, config)
        state.clear_export()
