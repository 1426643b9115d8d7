"""Interactive client viewer — the reference Unity demo in a browser (port
of ``dragposer_tpu/cli/interactive.py``, on the port's realtime engine).

Replicates ``Applications/FBIK.cs`` (draggable end effectors, live per-joint
mask toggles and weight sliders, damped root adjustment) and
``BVH/BVHPlayback.cs`` (animation-driven trackers with pause/reset) against
the realtime engine, serving a dependency-free canvas viewer
(``client/viewer.html``) over stdlib HTTP.

    python -m dragposer_tpu_torch.cli.interactive <model_dir> --bvh clip.bvh
        [--port 8787] [--window 60] [--max-iter 10] [--device cuda|cpu]

Endpoints: ``GET /`` the viewer; ``POST /api/step`` one client frame
(body: mode/mask/weights/moved trackers/adjust/smooth) → world-space
skeleton + tracker positions; ``POST /api/pause|pb_reset|reset_mask``.

FBIK semantics (``FBIK.cs:36-71``): inactive end-effector gizmos follow the
reconstructed body; active ones are user-dragged and drive the trackers.
"""

from __future__ import annotations

import argparse
import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

VIEWER = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "client", "viewer.html")


class InteractiveApp:
    """Server-side session state shared across requests (lock-serialized)."""

    def __init__(self, model_dir: str, bvh_path: str, *, window: int = 60,
                 max_iter: int = 10, start_frame: int = 0, device=None):
        from dragposer_tpu_torch.client.driver import ClientDragPoser
        from dragposer_tpu_torch.client.playback import BVHPlayback

        self.lock = threading.Lock()
        self.poser = ClientDragPoser(bvh_path, model_dir,
                                     temporal_future_window=window,
                                     max_iter=max_iter, log_path=None,
                                     device=device)
        self.playback = BVHPlayback(bvh_path, self.poser.retargeter)
        self.playback.frame = start_frame
        self.playback.update_trackers()
        self.poser.initialize_pose()
        # FBIK end-effector gizmos: world positions the user drags
        pos, rot = self.poser.world_pose()
        self.ee_pos = pos.copy()
        self.ee_rot = rot.copy()
        self.names = self.poser.retargeter.names
        self.bones = [[int(self.poser.parents[i]), i]
                      for i in range(1, self.poser.n_joints)]
        self.last_dt = 1.0 / 30.0
        self._last_step = time.time()

    # ------------------------------------------------------------------
    def step(self, req: dict) -> dict:
        with self.lock:
            now = time.time()
            dt = min(max(now - self._last_step, 1e-3), 0.1)
            self._last_step = now
            poser, retargeter = self.poser, self.poser.retargeter

            poser.mask = np.asarray(req.get("mask", poser.mask), np.float32)
            w = np.asarray(req.get("weights", poser.weights), np.float32)
            poser.weights = w.reshape(poser.n_joints, 2)
            poser.do_adjustment = bool(req.get("adjust", True))
            poser.rotation_smooth = float(req.get("smooth", 10.0))

            mode = req.get("mode", "fbik")
            if mode == "playback":
                frame = self.playback.update_trackers()
            else:
                frame = self.playback.frame
                # FBIK.cs:36-57 — inactive gizmos follow the body; active
                # gizmos (possibly just dragged) drive the trackers
                for i, p in req.get("moved", []):
                    self.ee_pos[int(i)] = np.asarray(p, np.float32)
                body_pos, body_rot = poser.world_pose()
                for i in range(poser.n_joints):
                    if poser.mask[i] > 0.1:
                        retargeter.set_tracker(i, self.ee_pos[i],
                                               self.ee_rot[i])
                    else:
                        self.ee_pos[i] = body_pos[i]
                        self.ee_rot[i] = body_rot[i]
                retargeter.retarget_all()

            t0 = time.time()
            poser.step(dt)
            engine_ms = (time.time() - t0) * 1e3

            pos, _ = poser.world_pose()
            trackers = (self.ee_pos if mode == "fbik"
                        else retargeter.tracker_pos)
            return {
                "joints": pos.tolist(),
                "trackers": trackers.tolist(),
                "names": self.names,
                "mask": poser.mask.tolist(),
                "weights": poser.weights.tolist(),
                "bones": self.bones,
                "frame": int(frame),
                "engine_ms": engine_ms,
            }

    def reset_mask(self) -> dict:
        """FBIK.cs:124-141 defaults."""
        with self.lock:
            j = self.poser.n_joints
            mask = np.zeros(j, np.float32)
            mask[[0, 3, 7, 13, 17, 21]] = 1.0
            weights = np.ones((j, 2), np.float32)
            weights[0, 0] = 10.0
            weights[[3, 7, 13, 17, 21], 0] = 5.0
            self.poser.mask, self.poser.weights = mask, weights
            return {"mask": mask.tolist(), "weights": weights.tolist()}

    def pause(self) -> dict:
        with self.lock:
            self.playback.paused = not self.playback.paused
            return {"paused": self.playback.paused}

    def pb_reset(self) -> dict:
        with self.lock:
            self.playback.reset()
            return {"frame": 0}


def make_handler(app: InteractiveApp):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _json(self, obj, code=200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path in ("/", "/index.html"):
                with open(VIEWER, "rb") as f:
                    body = f.read()
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._json({"error": "not found"}, 404)

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(n) or b"{}")
            if self.path == "/api/step":
                self._json(app.step(req))
            elif self.path == "/api/reset_mask":
                self._json(app.reset_mask())
            elif self.path == "/api/pause":
                self._json(app.pause())
            elif self.path == "/api/pb_reset":
                self._json(app.pb_reset())
            else:
                self._json({"error": "not found"}, 404)

    return Handler


def main(argv=None):
    ap = argparse.ArgumentParser(description="Interactive DragPoser viewer")
    ap.add_argument("model_path", type=str)
    ap.add_argument("--bvh", type=str, required=True,
                    help="skeleton/T-pose + playback animation")
    ap.add_argument("--port", type=int, default=8787)
    ap.add_argument("--window", type=int, default=60)
    ap.add_argument("--max-iter", type=int, default=10)
    ap.add_argument("--start-frame", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    print("loading models + compiling engine…", flush=True)
    app = InteractiveApp(args.model_path, args.bvh, window=args.window,
                         max_iter=args.max_iter, start_frame=args.start_frame,
                         device=args.device)
    server = ThreadingHTTPServer(("127.0.0.1", args.port), make_handler(app))
    print(f"viewer at http://127.0.0.1:{args.port}/  (Ctrl-C to stop)",
          flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
