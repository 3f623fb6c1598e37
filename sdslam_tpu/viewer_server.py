"""Live web viewer: the interactive counterpart of the headless renderer.

The reference opens a Pangolin GL window with map/frame views and menu
buttons (reference src/ui/Viewer.cc:68-120). Accelerator hosts are often headless,
so the live UI here is a zero-dependency HTTP server (stdlib http.server)
that any browser can watch while a CLI run or StreamRunner is tracking:

    GET /            auto-refreshing HTML dashboard
    GET /map.png     top-down map render (viewer.draw_map)
    GET /frame.png   current frame + keypoint overlay (viewer.draw_frame)
    GET /ar.png      AR overlay (cube + grid on detected planes)
    GET /status.json tracking state, KF/point counts, trajectory length
    POST /reset              -> queue System.reset()     (menu "Reset")
    POST /localization/<on|off> -> queue localization toggle (menu toggle)
    POST /plane/add          -> queue AR plane detection (menu "Add plane")
    POST /plane/clear        -> clear AR planes          (menu "Clear planes")
    POST /stop_save          -> request stop+save        (menu "Stop and Save")

The menu actions mirror the Pangolin buttons (Viewer.cc:112-120), INCLUDING
the deferred-application pattern: Pangolin menu clicks set flags the
tracking loop consumes at a frame boundary (Viewer::CheckMenu); here POSTs
enqueue actions that SDSlamSystem applies in _after_frame. Applying them on
the HTTP handler thread would race the tracking loop's own drains (reset
reassigns tracker.ms/st while track() is mid-flight). Renders are produced
on demand (rate-limited) from the live SDSlamSystem — reads of MapState
snapshots are safe by construction (immutable pytrees).
"""

from __future__ import annotations

import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

_PAGE = """<!doctype html>
<html><head><title>sdslam_tpu live viewer</title>
<style>
 body {{ background:#111; color:#ddd; font-family:monospace; }}
 img {{ border:1px solid #444; max-width:48%; }}
 button {{ background:#333; color:#ddd; border:1px solid #666;
          padding:4px 10px; margin-right:8px; }}
</style></head>
<body>
<h3>sdslam_tpu</h3>
<div id="status">connecting...</div>
<p>
 <button onclick="fetch('/reset',{{method:'POST'}})">Reset</button>
 <button onclick="fetch('/localization/on',{{method:'POST'}})">Localization on</button>
 <button onclick="fetch('/localization/off',{{method:'POST'}})">Localization off</button>
 <button onclick="fetch('/plane/add',{{method:'POST'}})">Add AR plane</button>
 <button onclick="fetch('/plane/clear',{{method:'POST'}})">Clear planes</button>
 <button onclick="fetch('/stop_save',{{method:'POST'}})">Stop and Save</button>
</p>
<img id="map" src="/map.png"> <img id="frame" src="/frame.png">
<script>
 setInterval(() => {{
   fetch('/status.json').then(r => r.json()).then(s => {{
     document.getElementById('status').textContent = JSON.stringify(s);
   }});
   document.getElementById('map').src = '/map.png?' + Date.now();
   document.getElementById('frame').src = '/frame.png?' + Date.now();
 }}, {refresh_ms});
</script>
</body></html>
"""


class LiveViewer:
    """Serve a live view of a running SDSlamSystem.

    system: SDSlamSystem (or any object with .tracker/.reset()/
    .activate_localization_mode()/.deactivate_localization_mode()).
    min_render_interval throttles matplotlib renders so the viewer never
    competes with the tracking loop for host CPU.
    """

    def __init__(self, system, min_render_interval: float = 0.5,
                 refresh_ms: int = 1000):
        self.system = system
        self.refresh_ms = refresh_ms
        self._min_dt = float(min_render_interval)
        self._lock = threading.Lock()
        self._cache = {}  # path -> (t, bytes)
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        # menu actions queued by HTTP handlers, applied by the tracking
        # thread at a frame boundary (the reference's CheckMenu flag
        # pattern, Viewer.cc:112-120)
        self._actions: list = []
        self.planes: list = []  # detected AR planes [(normal, d, n_inliers)]
        # plane detections staged as async device->host copies (finished on
        # a later frame boundary — a synchronous fetch here can cost
        # 200-350 ms per array in degraded link regimes)
        self._staged_planes: list = []
        # the tracking side polls this viewer (SDSlamSystem._after_frame)
        setattr(system, "_live_viewer", self)

    # -- queued menu actions -------------------------------------------------

    def request(self, action: str):
        """Queue a menu action for the owning tracking loop."""
        with self._lock:
            self._actions.append(action)

    def apply_pending(self):
        """Apply queued menu actions — MUST be called from the thread that
        owns the tracking loop, at a frame boundary (never from the HTTP
        handler: reset/localization mutate tracker state the frame loop is
        concurrently using). Returns the list of applied actions."""
        with self._lock:
            actions, self._actions = self._actions, []
        for a in actions:
            if a == "reset":
                self.system.reset()
                setattr(self.system, "_live_viewer", self)
                self.planes.clear()
            elif a == "localization_on":
                self.system.activate_localization_mode()
            elif a == "localization_off":
                self.system.deactivate_localization_mode()
            elif a == "plane_add":
                self._stage_plane()
            elif a == "plane_clear":
                self.planes.clear()
                self._staged_planes.clear()
            elif a == "stop_save":
                # System::RequestStop (Viewer.cc "Stop and Save"): the
                # front-end loop exits at this frame boundary and saves
                self.system.request_stop()
        self._finish_planes()
        return actions

    def _stage_plane(self):
        """Stage an AR plane detection (menu "Add plane", Viewer.cc:112-120
        / FrameDrawer::DetectPlane): dispatch ASYNC device->host copies of
        the point cloud now; the RANSAC runs at a later frame boundary once
        the copies land (`_finish_planes`). jnp.copy makes independent
        buffers so the fused step's donation of ms cannot invalidate them."""
        import jax.numpy as jnp

        tr = self.system.tracker
        pos = jnp.copy(tr.ms.pt_pos)
        valid = jnp.copy(tr.ms.pt_valid)
        for a in (pos, valid):
            try:
                a.copy_to_host_async()
            except AttributeError:  # non-jax array (tests with numpy state)
                pass
        self._staged_planes.append((pos, valid))

    def _finish_planes(self):
        """Complete staged plane detections whose host copies are ready."""
        from sdslam_tpu import viewer as V

        still = []
        for pos, valid in self._staged_planes:
            ready = all(
                getattr(a, "is_ready", lambda: True)() for a in (pos, valid)
            )
            if not ready:
                still.append((pos, valid))
                continue
            pts = np.asarray(pos)[np.asarray(valid)]
            res = V.detect_plane(pts, seed=len(self.planes))
            if res is not None:
                # keep the point snapshot: the inlier mask indexes it, and
                # draw_ar anchors the grid on the inlier centroid
                self.planes.append({"plane": res, "points": pts})
        self._staged_planes = still

    # -- render producers ---------------------------------------------------

    def _png(self, draw) -> bytes:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig = draw()
        buf = io.BytesIO()
        fig.savefig(buf, format="png", dpi=80)
        plt.close(fig)
        return buf.getvalue()

    def map_png(self) -> bytes:
        from sdslam_tpu import viewer

        tr = self.system.tracker
        traj = [p for p in tr.trajectory if p is not None]
        return self._png(lambda: viewer.draw_map(tr.ms, trajectory=traj))

    def frame_png(self) -> bytes:
        from sdslam_tpu import viewer

        tr = self.system.tracker
        fr = tr.st.last_frame
        if fr is None:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            fig, ax = plt.subplots()
            ax.text(0.5, 0.5, "no frames yet", ha="center")
            return self._png(lambda: fig)
        f = fr.features
        return self._png(
            lambda: viewer.draw_frame(
                np.asarray(fr.pyramid[0]),
                np.asarray(f.uv)[np.asarray(f.valid)],
                state_text=self.status()["state"],
            )
        )

    def ar_png(self) -> bytes:
        """AR overlay on the current frame: cube + grid per detected plane
        (FrameDrawer::DrawCube/DrawPlane; menu-driven like the reference)."""
        from sdslam_tpu import viewer as V

        tr = self.system.tracker
        fr = tr.st.last_frame
        if fr is None or not self.planes:
            return self._cached("frame", self.frame_png)
        img = np.asarray(fr.pyramid[0])
        Tcw = np.asarray(tr.st.T_last)
        arr = None
        for p in self.planes:
            arr = V.draw_ar(
                img if arr is None else arr,
                self.system.config.camera, Tcw, p["plane"],
                points=p["points"],
            )
        from PIL import Image

        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, "PNG")
        return buf.getvalue()

    def status(self) -> dict:
        tr = self.system.tracker
        return {
            "state": tr.st.status,
            "keyframes": int(np.asarray(tr.ms.kf_valid).sum()),
            "points": int(np.asarray(tr.ms.pt_valid).sum()),
            "frames": len(tr.trajectory),
            "localization_only": bool(
                getattr(self.system, "localization_only", False)
            ),
            "planes": len(self.planes),
            "pending_actions": len(self._actions) + len(self._staged_planes),
            "stop_requested": bool(
                getattr(self.system, "stop_requested", False)
            ),
        }

    def _cached(self, key: str, producer) -> bytes:
        with self._lock:
            t, data = self._cache.get(key, (0.0, None))
            if data is not None and time.monotonic() - t < self._min_dt:
                return data
            data = producer()
            self._cache[key] = (time.monotonic(), data)
            return data

    # -- http ----------------------------------------------------------------

    def _handler(self):
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code, ctype, body: bytes):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?")[0]
                try:
                    if path == "/":
                        page = _PAGE.format(refresh_ms=viewer.refresh_ms)
                        self._send(200, "text/html", page.encode())
                    elif path == "/map.png":
                        self._send(200, "image/png",
                                   viewer._cached("map", viewer.map_png))
                    elif path == "/frame.png":
                        self._send(200, "image/png",
                                   viewer._cached("frame", viewer.frame_png))
                    elif path == "/ar.png":
                        self._send(200, "image/png",
                                   viewer._cached("ar", viewer.ar_png))
                    elif path == "/status.json":
                        self._send(200, "application/json",
                                   json.dumps(viewer.status()).encode())
                    else:
                        self._send(404, "text/plain", b"not found")
                except Exception as e:  # pragma: no cover - render race
                    self._send(500, "text/plain", str(e).encode())

            def do_POST(self):
                # actions are QUEUED for the tracking loop (frame-boundary
                # application), not applied on this handler thread
                actions = {
                    "/reset": "reset",
                    "/localization/on": "localization_on",
                    "/localization/off": "localization_off",
                    "/plane/add": "plane_add",
                    "/plane/clear": "plane_clear",
                    "/stop_save": "stop_save",
                }
                a = actions.get(self.path)
                if a is None:
                    self._send(404, "text/plain", b"not found")
                else:
                    viewer.request(a)
                    self._send(200, "text/plain", b"queued")

        return Handler

    def start(self, port: int = 8580, host: str = "127.0.0.1"):
        """Start serving in a daemon thread; returns the bound port."""
        self._server = ThreadingHTTPServer((host, port), self._handler())
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )
        self._thread.start()
        return self._server.server_address[1]

    def stop(self):
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
