"""Interactive browser viewer, serving renders from the card.

Counterpart of ``fvsrn_tpu/viewer.py``: orbit the camera around a scene,
scale the transfer function's opacity and pick the resolution in a
single-page UI served over HTTP (drag to orbit, wheel to dolly). Renders
run through the port's ``ImageEvaluatorSimple`` on the evaluator's device
(``--device``, the card by default), one at a time under a lock;
Monte-Carlo evaluators refine progressively across requests at the same
parameters. The page, its endpoints (``/``, ``/render``, ``/meta``),
their query parameters, the ``X-Frames`` header and the 500-with-JSON
answer to a failed render are the JAX package's. One difference on
purpose: the page's refresh loop retries after a failed fetch (with a
small backoff), keeping its pending and progressive work, where the JAX
page stops until the next input.

Usage::

    python -m fvsrn_tpu_torch.viewer --equation MARSCHNER_LOBB --port 8787
    # or in code:
    from fvsrn_tpu_torch.viewer import serve
    serve(evaluator, port=8787)
"""
from __future__ import annotations

import argparse
import dataclasses
import io
import json
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

_PAGE = """<!DOCTYPE html>
<html><head><title>fvsrn_tpu viewer</title><style>
body { margin:0; background:#111; color:#ddd; font:13px sans-serif; }
#wrap { display:flex; }
#img { cursor:grab; image-rendering:pixelated; }
#panel { padding:12px; min-width:220px; }
label { display:block; margin-top:10px; }
input[type=range] { width:200px; }
</style></head><body><div id="wrap">
<img id="img" width="512" height="512"/>
<div id="panel">
  <b>fvsrn_tpu viewer</b>
  <label>pitch <span id="pv"></span>
    <input id="pitch" type="range" min="-1.4" max="1.4" step="0.02" value="0.35"></label>
  <label>yaw <span id="yv"></span>
    <input id="yaw" type="range" min="0" max="6.28" step="0.02" value="0.6"></label>
  <label>distance <span id="dv"></span>
    <input id="dist" type="range" min="0.8" max="4" step="0.05" value="1.8"></label>
  <label>opacity scale <span id="ov"></span>
    <input id="opac" type="range" min="0.1" max="4" step="0.1" value="1"></label>
  <label>resolution
    <select id="res"><option>128</option><option selected>256</option>
    <option>512</option></select></label>
  <div id="stat" style="margin-top:12px;color:#8a8"></div>
</div></div>
<script>
const img = document.getElementById('img');
let busy = false, dirty = false;
let progressive = false, maxFrames = 32;
let failures = 0;
fetch('/meta').then(r => r.json()).then(m => {
  progressive = m.progressive; maxFrames = m.max_frames;
}).catch(() => {});
async function refresh() {
  if (busy) { dirty = true; return; }
  busy = true;
  const q = new URLSearchParams({
    pitch: pitch.value, yaw: yaw.value, distance: dist.value,
    opacity: opac.value, size: res.value, t: Date.now()});
  pv.textContent = pitch.value; yv.textContent = yaw.value;
  dv.textContent = dist.value; ov.textContent = opac.value;
  const t0 = performance.now();
  try {
    const r = await fetch('/render?' + q);
    const frames = +(r.headers.get('X-Frames') || 1);
    const old = img.src;
    img.src = URL.createObjectURL(await r.blob());
    if (old.startsWith('blob:')) URL.revokeObjectURL(old);
    stat.textContent = (performance.now() - t0).toFixed(0) + ' ms'
      + (progressive ? ' · ' + frames + ' passes' : '');
    failures = 0;
    busy = false;
    if (dirty) { dirty = false; refresh(); }
    else if (progressive && frames < maxFrames)
      setTimeout(refresh, 30);  // keep refining while idle (MC mode)
  } catch (e) {
    // a failed fetch: retry after a backoff, keeping the pending change
    // (dirty) and the progressive refinement
    busy = false;
    failures += 1;
    stat.textContent = 'fetch failed, retrying';
    setTimeout(refresh, Math.min(2000, 100 * 2 ** Math.min(failures, 5)));
  }
}
for (const el of [pitch, yaw, dist, opac, res])
  el.addEventListener('input', refresh);
let drag = null;
img.addEventListener('mousedown', e => drag = [e.clientX, e.clientY]);
window.addEventListener('mouseup', () => drag = null);
window.addEventListener('mousemove', e => {
  if (!drag) return;
  yaw.value = (+yaw.value + (e.clientX - drag[0]) * 0.01 + 6.28) % 6.28;
  pitch.value = Math.max(-1.4, Math.min(1.4,
      +pitch.value + (e.clientY - drag[1]) * 0.01));
  drag = [e.clientX, e.clientY];
  refresh();
});
img.addEventListener('wheel', e => {
  e.preventDefault();
  dist.value = Math.max(0.8, Math.min(4,
      +dist.value * (e.deltaY > 0 ? 1.05 : 0.95)));
  refresh();
});
refresh();
</script></body></html>"""


class ViewerState:
    """Render backend shared by requests, on the evaluator's device
    (``device``, the card by default; the evaluator's volume must lie
    there). DVR and iso evaluators render each request anew
    (``ImageEvaluatorSimple.render`` with the volume's step bound);
    Monte-Carlo evaluators render progressively: repeated
    requests at the same camera and TF fold one more pass each into a
    running mean (``raytracer.evaluator.ProgressiveRenderer``), up to
    ``MAX_REFINE_FRAMES``, and any parameter change resets it."""

    MAX_REFINE_FRAMES = 32

    def __init__(self, evaluator, device="cuda"):
        from .raytracer.dvr import max_steps_bound
        from .utils.device import resolve_device
        self.evaluator = evaluator
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._prog = {}        # size -> ProgressiveRenderer
        self._prog_params = None
        # the DVR and iso marches' step bound, the same for every request
        # (an MC walk has none)
        self._steps = None if self.progressive else max_steps_bound(
            evaluator.volume.box_size.tolist(),
            float(evaluator.ray_config.stepsize))

    @property
    def progressive(self) -> bool:
        return getattr(self.evaluator, "ray_mode", "dvr") == "mc"

    def render_image(self, pitch, yaw, distance, opacity, size):
        """The request's image (1, 8, size, size) on the device, and the
        passes accumulated into it."""
        from .camera import CameraOnASphere
        cam = CameraOnASphere.make(pitch=pitch, yaw=yaw, distance=distance)
        ev = dataclasses.replace(self.evaluator, camera=cam)
        if opacity != 1.0 and hasattr(ev.tf, "tensor"):
            t = ev.tf.tensor.detach().clone()
            t[:, 3] = t[:, 3] * opacity
            ev = dataclasses.replace(ev, tf=type(ev.tf)(t))
        with self._lock:   # one render on the card at a time
            if not self.progressive:
                return ev.render(size, size, max_steps=self._steps,
                                 device=self.device), 1
            from .raytracer.evaluator import ProgressiveRenderer
            params = (pitch, yaw, distance, opacity, size)
            pr = self._prog.get(size)
            if pr is None:
                pr = ProgressiveRenderer(ev, size, size, device=self.device)
                self._prog[size] = pr
                self._prog_params = None
            if params != self._prog_params:
                # camera or TF moved: swap the evaluator and restart
                pr.evaluator = ev
                pr.reset()
                self._prog_params = params
            if pr.frames < self.MAX_REFINE_FRAMES:
                pr.refine(1)
            return pr.image, pr.frames

    def render_png(self, pitch, yaw, distance, opacity, size):
        """Returns (png_bytes, accumulated_frames)."""
        img, frames = self.render_image(pitch, yaw, distance, opacity, size)
        rgb = torch.clamp(torch.movedim(img[0, :3], 0, -1), 0, 1)
        arr = (rgb * 255).to(torch.uint8).cpu().numpy()
        try:
            from PIL import Image
            buf = io.BytesIO()
            Image.fromarray(arr).save(buf, format="PNG")
            return buf.getvalue(), frames
        except ImportError:
            return _encode_png(arr), frames


def _encode_png(arr: np.ndarray) -> bytes:
    """Minimal PNG writer (rgb8), used where PIL is not installed."""
    import struct
    import zlib

    h, w, _ = arr.shape
    raw = b"".join(b"\x00" + arr[y].tobytes() for y in range(h))

    def chunk(tag, data):
        c = struct.pack(">I", len(data)) + tag + data
        return c + struct.pack(">I", zlib.crc32(tag + data))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw))
            + chunk(b"IEND", b""))


def make_handler(state: ViewerState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, ctype, body, headers=()):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in headers:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            u = urlparse(self.path)
            if u.path == "/":
                self._send(200, "text/html", _PAGE.encode())
                return
            if u.path == "/render":
                q = parse_qs(u.query)

                def f(k, d):
                    return float(q.get(k, [d])[0])

                try:
                    png, frames = state.render_png(
                        pitch=f("pitch", 0.35), yaw=f("yaw", 0.6),
                        distance=f("distance", 1.8),
                        opacity=f("opacity", 1.0),
                        size=int(f("size", 256)))
                except Exception as e:  # surface render errors as 500s
                    self._send(500, "application/json",
                               json.dumps({"error": str(e)}).encode())
                    return
                self._send(200, "image/png", png,
                           (("X-Frames", str(frames)),))
                return
            if u.path == "/meta":
                self._send(200, "application/json", json.dumps({
                    "progressive": state.progressive,
                    "max_frames": state.MAX_REFINE_FRAMES,
                }).encode())
                return
            self.send_response(404)
            self.end_headers()

    return Handler


def serve(evaluator, port: int = 8787, host: str = "127.0.0.1",
          block: bool = True, device="cuda"):
    """Serve the viewer, rendering on ``device``. ``block=False`` returns
    the server, serving from a daemon thread (tests); stop it with
    ``server.shutdown()``."""
    state = ViewerState(evaluator, device=device)
    server = ThreadingHTTPServer((host, port), make_handler(state))
    if block:
        print(f"fvsrn_tpu_torch viewer on "
              f"http://{host}:{server.server_port}/", flush=True)
        server.serve_forever()
    else:
        t = threading.Thread(target=server.serve_forever, daemon=True)
        t.start()
    return server


def default_evaluator(equation: str = "MARSCHNER_LOBB", cvol=None,
                      stepsize: float = 1 / 256, device="cuda"):
    """The viewer's scene: an implicit volume (``equation``) or a
    ``.cvol`` file's first feature, the three-knot TF, DVR at
    ``stepsize``, on ``device``."""
    from .camera import CameraOnASphere
    from .raytracer.dvr import RayEvaluationSteppingDvr
    from .raytracer.evaluator import ImageEvaluatorSimple
    from .transfer import TransferFunctionPiecewiseLinear
    from .utils.device import resolve_device
    from .volume.implicit import VolumeInterpolationImplicit
    dev = resolve_device(device)
    if cvol:
        from .volume.grid import VolumeInterpolationGrid
        from .volume.volume import Volume
        vol = VolumeInterpolationGrid.from_grid(
            torch.as_tensor(Volume.load(cvol).density, device=dev))
    else:
        vol = VolumeInterpolationImplicit.make(equation, device=dev)
    tf = TransferFunctionPiecewiseLinear.make(
        rgb=[[0.1, 0.1, 0.8], [0.8, 0.3, 0.1], [1.0, 1.0, 0.6]],
        opacity=[0.0, 8.0, 25.0], positions=[0.0, 0.5, 1.0])
    cfg = RayEvaluationSteppingDvr.make(stepsize=stepsize)
    cam = CameraOnASphere.make(pitch=0.35, yaw=0.6, distance=1.8)
    return ImageEvaluatorSimple(camera=cam, volume=vol, tf=tf,
                                ray_config=cfg)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--equation", default="MARSCHNER_LOBB")
    p.add_argument("--cvol", default=None, help=".cvol volume to view")
    p.add_argument("--stepsize", type=float, default=1 / 256)
    p.add_argument("--port", type=int, default=8787)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--device", default="cuda",
                   help="render device (cuda, or cpu for the plain path); "
                        "a missing card raises")
    args = p.parse_args(argv)
    ev = default_evaluator(args.equation, args.cvol, args.stepsize,
                           args.device)
    serve(ev, port=args.port, host=args.host, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
