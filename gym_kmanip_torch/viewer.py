"""Live interactive viewer: a browser analog of dm_control.viewer.

Port of `gym_kmanip_tpu/viewer.py`. A headless GPU host has no GUI, so
this serves the env's rendered frames over plain HTTP (standard library
only) to any browser, with keyboard teleop driving the env's action space:

    W/S  EE forward/back (y)      A/D   EE left/right (x)
    Q/E  EE down/up (z)           J/L   EE yaw -, +
    space  toggle gripper          R     reset episode
    P    pause/resume stepping

Usage (also wired into examples/0_viewer.py --live):

    env = gym.make("gym_kmanip_torch/KManipSoloArm")
    LiveViewer(env).run()          # serves http://127.0.0.1:8008

The env steps in the main thread (its device work and the render); the
HTTP server runs on daemon threads and only swaps bytes and state under a
lock. The browser polls /frame.png (~20 Hz) and posts key events to
/action; with no browser the env idles when paused or steps a zero
action. The env's frames and observations come back as host numpy.
"""

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

import numpy as np

_PAGE = """<!DOCTYPE html>
<html><head><title>gym-kmanip-torch live viewer</title><style>
 body { background:#151515; color:#ddd; font-family:monospace; text-align:center }
 img  { image-rendering:pixelated; width:640px; border:1px solid #444; margin-top:12px }
 #hud { margin-top:8px }
 kbd  { background:#333; padding:1px 5px; border-radius:3px }
</style></head><body>
<h3>gym-kmanip-torch &mdash; live viewer</h3>
<div><kbd>W</kbd>/<kbd>S</kbd> fwd/back &nbsp;<kbd>A</kbd>/<kbd>D</kbd> left/right
 &nbsp;<kbd>Q</kbd>/<kbd>E</kbd> down/up &nbsp;<kbd>J</kbd>/<kbd>L</kbd> yaw
 &nbsp;<kbd>space</kbd> grip &nbsp;<kbd>R</kbd> reset &nbsp;<kbd>P</kbd> pause</div>
<img id="view" src="/frame.png">
<div id="hud">connecting...</div>
<script>
const img = document.getElementById("view"), hud = document.getElementById("hud");
function refresh() {
  img.src = "/frame.png?t=" + Date.now();
  fetch("/state").then(r => r.json()).then(s => {
    hud.textContent = `step ${s.step}  reward ${s.reward.toFixed(3)}` +
      `  grip ${s.grip.toFixed(2)}` + (s.paused ? "  [PAUSED]" : "");
  }).catch(() => { hud.textContent = "server gone"; });
}
setInterval(refresh, 50);
document.addEventListener("keydown", ev => {
  fetch("/action", {method: "POST", body: JSON.stringify({key: ev.key})});
});
</script></body></html>"""

_KEY_DELTAS = {  # key -> (action name suffix, axis, sign)
    "w": ("pos", 1, +1.0), "s": ("pos", 1, -1.0),
    "a": ("pos", 0, -1.0), "d": ("pos", 0, +1.0),
    "q": ("pos", 2, -1.0), "e": ("pos", 2, +1.0),
    "j": ("orn", 2, -1.0), "l": ("orn", 2, +1.0),
}


def _encode_png(frame: np.ndarray) -> bytes:
    import imageio.v3 as iio

    return iio.imwrite("<bytes>", frame, extension=".png")


class LiveViewer:
    """Serve a KManipEnv interactively over HTTP on a headless host."""

    def __init__(self, env, host: str = "127.0.0.1", port: int = 8008,
                 fps: float = 20.0):
        self.env = env
        self.host, self.port = host, port
        self.fps = fps
        self._lock = threading.Lock()
        self._png: bytes = b""
        self._state = {"step": 0, "reward": 0.0, "grip": 0.0, "paused": False}
        self._pending: Dict[str, float] = {}  # key -> impulse countdown
        self._grip = -1.0
        self._want_reset = False
        self._paused = False
        self._stop = False
        self._side = "r" if any(
            a.startswith("eer") for a in self._act_names()) else "l"
        self._httpd: Optional[ThreadingHTTPServer] = None

    # -- env plumbing -------------------------------------------------------
    def _act_names(self):
        unwrapped = getattr(self.env, "unwrapped", self.env)
        space = getattr(unwrapped, "action_space", None)
        return list(space.spaces) if hasattr(space, "spaces") else []

    def _zero_action(self):
        unwrapped = getattr(self.env, "unwrapped", self.env)
        return {
            name: np.zeros(sp.shape, dtype=np.float32)
            for name, sp in unwrapped.action_space.spaces.items()
        }

    def _compose_action(self):
        """Fold queued key impulses into one env action."""
        act = self._zero_action()
        with self._lock:
            pending, self._pending = self._pending, {}
            grip, want_reset = self._grip, self._want_reset
            self._want_reset = False
        for key in pending:
            hit = _KEY_DELTAS.get(key)
            if hit is None:
                continue
            kind, axis, sign = hit
            name = f"ee{self._side}_{kind}"
            if name in act:
                act[name][axis] = sign
        for g in ("grip_r", "grip_l"):
            if g in act:
                act[g][:] = grip
        return act, want_reset

    # -- HTTP ---------------------------------------------------------------
    def _make_handler(viewer):  # noqa: N805 — closure-style handler factory
        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # silence per-request stderr spam
                pass

            def _send(self, code, body, ctype):
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
                    with viewer._lock:
                        png = viewer._png
                    if png:
                        self._send(200, png, "image/png")
                    else:
                        self._send(503, b"no frame yet", "text/plain")
                elif path == "/state":
                    with viewer._lock:
                        body = json.dumps(viewer._state).encode()
                    self._send(200, body, "application/json")
                else:
                    self._send(404, b"not found", "text/plain")

            def do_POST(self):
                if self.path.split("?")[0] != "/action":
                    self._send(404, b"not found", "text/plain")
                    return
                n = int(self.headers.get("Content-Length", 0))
                try:
                    msg = json.loads(self.rfile.read(n) or b"{}")
                except json.JSONDecodeError:
                    self._send(400, b"bad json", "text/plain")
                    return
                viewer.handle_key(str(msg.get("key", "")))
                self._send(200, b"ok", "text/plain")

        return Handler

    def handle_key(self, key: str):
        """Apply one key event (shared by HTTP handler and tests)."""
        key = key.lower()
        with self._lock:
            if key == " " or key == "space":
                self._grip = -self._grip
            elif key == "r":
                self._want_reset = True
            elif key == "p":
                self._paused = not self._paused
                self._state["paused"] = self._paused
            elif key in _KEY_DELTAS:
                self._pending[key] = 1.0

    # -- lifecycle ----------------------------------------------------------
    def start_server(self):
        self._httpd = ThreadingHTTPServer(
            (self.host, self.port), self._make_handler()
        )
        self.port = self._httpd.server_address[1]  # resolve port 0
        threading.Thread(target=self._httpd.serve_forever, daemon=True).start()
        return f"http://{self.host}:{self.port}"

    def stop(self):
        self._stop = True
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None

    def step_once(self):
        """One viewer tick: compose action, step env, publish frame."""
        action, want_reset = self._compose_action()
        if want_reset:
            self.env.reset()
            with self._lock:
                self._state["step"] = 0
        if self._paused and not want_reset:
            return
        obs, reward, terminated, truncated, info = self.env.step(action)
        if terminated or truncated:
            self.env.reset()
        frame = self.env.render()
        png = _encode_png(np.asarray(frame))
        with self._lock:
            self._png = png
            self._state["step"] += 1
            self._state["reward"] = float(reward)
            self._state["grip"] = float(self._grip)

    def run(self, n_steps: Optional[int] = None):
        """Serve + step until Ctrl-C (or n_steps ticks, for tests)."""
        url = self.start_server()
        print(f"live viewer at {url}  (Ctrl-C to stop)")
        self.env.reset()
        period = 1.0 / self.fps
        i = 0
        try:
            while not self._stop and (n_steps is None or i < n_steps):
                t0 = time.time()
                self.step_once()
                i += 1
                time.sleep(max(0.0, period - (time.time() - t0)))
        except KeyboardInterrupt:
            pass
        finally:
            self.stop()
