"""Interactive viewer: a local HTTP server streaming rendered frames.

The replacement for the reference's minifb window + arrow-key loop
(reference: src/main.rs:41-80).  An accelerator host is headless, so instead of
an OS window the viewer serves a small HTML page; the browser sends pose
updates (arrow keys = +-10 degrees yaw/pitch like the reference, R = reset,
drag to orbit, wheel to dolly) and fetches re-rendered PNG frames.  Like the
reference's dirty-flag loop, a frame is only rendered when the pose changed.

Stdlib-only (http.server); frames are encoded with the pure-python PNG
writer.  Single render thread — the device is serialized behind a lock.
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

_PAGE = """<!doctype html>
<html><head><title>splat_tpu viewer</title><style>
 body { margin:0; background:#111; color:#ccc; font:13px monospace; }
 #hud { position:fixed; top:8px; left:8px; background:#000a; padding:6px 10px;
        border-radius:4px; white-space:pre; }
 canvas { display:block; margin:0 auto; image-rendering:pixelated; }
</style></head>
<body>
<div id="hud">loading…</div>
<canvas id="view" width="__W__" height="__H__"></canvas>
<script>
let yaw = 0, pitch = 0, dist = 1.0, busy = false, dirty = true, t0 = 0;
let mode = '__MODE__', transport = '__TRANSPORT__';
const SCALES = [0.5, 1.0, 2.0];   // live resolution ladder ('-'/'+')
let scaleIdx = 1;
const hud = document.getElementById('hud');
const cv = document.getElementById('view');
const ctx = cv.getContext('2d');
function fit(w, h) {
  if (cv.width !== w || cv.height !== h) { cv.width = w; cv.height = h; }
}
async function tick() {
  if (dirty && !busy) {
    busy = true; dirty = false; t0 = performance.now();
    const q = `yaw=${yaw}&pitch=${pitch}&dist=${dist}&mode=${mode}` +
              `&scale=${SCALES[scaleIdx]}&t=${Date.now()}`;
    let overflow = 0;
    try {
      if (transport === 'raw') {
        // raw RGBA straight into the canvas: no PNG encode server-side
        // (~17 ms/1080p even at stored-block level 0), no decode here
        const r = await fetch('/frame.raw?' + q);
        overflow = parseInt(r.headers.get('X-Splat-Overflow') || '0');
        const w = parseInt(r.headers.get('X-Splat-W'));
        const h = parseInt(r.headers.get('X-Splat-H'));
        const buf = new Uint8ClampedArray(await r.arrayBuffer());
        fit(w, h);
        ctx.putImageData(new ImageData(buf, w, h), 0, 0);
      } else {
        const r = await fetch('/frame.png?' + q);
        overflow = parseInt(r.headers.get('X-Splat-Overflow') || '0');
        const bmp = await createImageBitmap(await r.blob());
        fit(bmp.width, bmp.height);
        ctx.drawImage(bmp, 0, 0);
      }
    } catch (e) {}
    const ms = (performance.now() - t0).toFixed(0);
    hud.textContent =
      `yaw ${(yaw*180/Math.PI).toFixed(1)}°  pitch ${(pitch*180/Math.PI).toFixed(1)}°` +
      `  dist x${dist.toFixed(2)}  ${cv.width}x${cv.height}  mode ${mode}  ${transport}  pose→pixels ${ms} ms\\n` +
      `arrows: orbit (±10°)   drag: orbit   wheel: dolly   R: reset   M: color/depth   T: transport   -/+: resolution` +
      (overflow > 0 ? `\\nWARNING: ${overflow} pairs dropped — ` +
                      `frame truncated; restart with a larger --dup-factor`
                    : '');
    busy = false;
  }
  requestAnimationFrame(tick);
}
const STEP = 10 * Math.PI / 180;           // reference: ±10° per keypress
addEventListener('keydown', e => {
  if (e.key === 'ArrowLeft')  { yaw -= STEP; dirty = true; }
  if (e.key === 'ArrowRight') { yaw += STEP; dirty = true; }
  if (e.key === 'ArrowUp')    { pitch += STEP; dirty = true; }
  if (e.key === 'ArrowDown')  { pitch -= STEP; dirty = true; }
  if (e.key === 'r' || e.key === 'R') { yaw = 0; pitch = 0; dist = 1; dirty = true; }
  if (e.key === 'm' || e.key === 'M') {
    mode = (mode === 'depth') ? 'color' : 'depth'; dirty = true;
  }
  if (e.key === 't' || e.key === 'T') {
    transport = (transport === 'raw') ? 'png' : 'raw'; dirty = true;
  }
  if (e.key === '-' || e.key === '_') {
    scaleIdx = Math.max(0, scaleIdx - 1); dirty = true;
  }
  if (e.key === '+' || e.key === '=') {
    scaleIdx = Math.min(SCALES.length - 1, scaleIdx + 1); dirty = true;
  }
});
let dragging = false, lx = 0, ly = 0;
cv.addEventListener('mousedown', e => { dragging = true; lx = e.clientX; ly = e.clientY; });
addEventListener('mouseup', () => dragging = false);
addEventListener('mousemove', e => {
  if (!dragging) return;
  yaw   += (e.clientX - lx) * 0.01;
  pitch -= (e.clientY - ly) * 0.01;
  lx = e.clientX; ly = e.clientY; dirty = true;
});
addEventListener('wheel', e => {
  dist = Math.min(10, Math.max(0.1, dist * (e.deltaY > 0 ? 1.1 : 0.9)));
  dirty = true;
});
tick();
</script></body></html>
"""


def serve(scene, camera, config=None, *, host: str = "127.0.0.1",
          port: int = 8000, method: str = "auto",
          png_level: int = 0, transport: str = "raw") -> None:
    """Serve the interactive viewer (blocking).  Ctrl-C to stop.

    transport: initial frame transport ('T' in the browser toggles live).
    "raw" (default): uncompressed RGBA straight into a canvas via
    putImageData — zero encode cost server-side and zero decode in the
    browser; the right choice on localhost, where encode latency IS
    serving latency.  "png": PNG at ``png_level`` for thin links
    (level 0 stored blocks cost ~17 ms/1080p to encode; ~340 ms at
    level 3 for ~3x fewer bytes — measured).
    """
    if transport not in ("raw", "png"):
        raise ValueError(f"transport must be 'raw' or 'png', "
                         f"got {transport!r}")
    import dataclasses

    import jax

    from splat_tpu.config import RenderConfig
    from splat_tpu.render.api import render_fn, resolve_method
    from splat_tpu.utils.compilecache import enable_persistent_cache
    from splat_tpu.utils.image import encode_png

    enable_persistent_cache()
    config = config or RenderConfig()

    # The tiled path renders with stats so duplication-buffer overflow is
    # surfaced in the HUD — the viewer must not be the one public render
    # surface that can truncate silently (config.py contract).
    # Render functions are built lazily per render mode: the browser's 'M'
    # key toggles color/depth live (one extra compile on first toggle).
    m = resolve_method(method, scene)
    fns: dict[tuple, object] = {}
    # Live resolution ladder ('-'/'+' in the browser): h/w are static
    # pytree metadata (a resize is a new compiled pipeline — PARITY.md
    # row 7's deliberate static-shape trade), so the viewer exposes a small
    # FIXED set of scales, each compiled once on first use and remembered
    # by the persistent compilation cache across restarts.  This covers
    # the reference's Camera::update_resolution (src/camera.rs:76-82).
    _SCALES = (0.5, 1.0, 2.0)

    def get_fn(mode: str, scale: float):
        key = (mode, scale)
        if key not in fns:
            cfg = dataclasses.replace(config, render_mode=mode)
            if m == "tiled" and scale > 1.0:
                # Pair demand grows ~scale² with pixels while the serve
                # config was capacity-sized at the 1.0x pose (CLI
                # --dup-factor auto): without this the 2.0x rung
                # overflows ~4x out of the box.  Scaling the 1.0x-sized
                # dup factor by scale² is always sufficient (pairs grow
                # ≤ scale², per-gaussian sentinel slots don't grow at
                # all); quantize so the per-(mode, scale) compile shapes
                # stay bucket-stable across nearby configs.
                import math

                dup = math.ceil(
                    config.max_dup_factor * scale * scale * 4) / 4
                cfg = dataclasses.replace(cfg, max_dup_factor=dup)
            if m == "tiled":
                from splat_tpu.render.tiled import render_tiled

                fns[key] = jax.jit(
                    lambda s, c: render_tiled(s, c, cfg, return_stats=True))
            else:
                f_plain = render_fn(m, cfg)
                fns[key] = lambda s, c: (f_plain(s, c), None)
        return fns[key]

    scene = scene.pack_device()
    lock = threading.Lock()
    base_pos = np.asarray(jax.device_get(camera.position))
    target = np.asarray(jax.device_get(camera.target))

    def render_pose(yaw: float, pitch: float, dist: float,
                    mode: str, scale: float) -> tuple[np.ndarray, int]:
        scale = min(_SCALES, key=lambda s: abs(s - scale))
        cam = camera.with_pose(
            yaw=yaw, pitch=pitch,
            position=target + (base_pos - target) * dist)
        if scale != 1.0:
            cam = dataclasses.replace(
                cam, h=max(8, int(camera.h * scale) & ~1),
                w=max(8, int(camera.w * scale) & ~1))
        with lock:
            img, stats = get_fn(mode, scale)(scene, cam)
            overflow = int(stats["overflow"]) if stats is not None else 0
            img = np.asarray(img)
        return img, overflow

    def to_rgba_u8(img: np.ndarray) -> bytes:
        """float (H, W, 3|4) -> raw RGBA bytes for canvas putImageData.

        In-place arithmetic + one preallocated write: 27 ms at 1080p vs
        68 ms for the naive clip/astype/concatenate chain and 54 ms for
        a stored-block PNG encode (measured) — and the browser skips the
        PNG decode entirely.
        """
        h, w, c = img.shape
        tmp = np.clip(img, 0.0, 1.0)
        tmp *= 255.0
        tmp += 0.5
        out = np.full((h, w, 4), 255, np.uint8)
        out[..., :c] = tmp.astype(np.uint8)
        return out.tobytes()

    page = (_PAGE.replace("__W__", str(camera.w))
            .replace("__H__", str(camera.h))
            .replace("__MODE__", config.render_mode)
            .replace("__TRANSPORT__", transport))

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def do_GET(self):
            from urllib.parse import parse_qs, urlparse

            u = urlparse(self.path)
            if u.path == "/":
                body = page.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif u.path in ("/frame.png", "/frame.raw"):
                q = parse_qs(u.query)
                get = lambda k, d: float(q.get(k, [d])[0])
                mode = q.get("mode", [config.render_mode])[0]
                if mode not in ("color", "depth"):
                    mode = config.render_mode
                try:
                    img, overflow = render_pose(
                        get("yaw", 0.0), get("pitch", 0.0),
                        get("dist", 1.0), mode, get("scale", 1.0))
                    if u.path == "/frame.raw":
                        body = to_rgba_u8(img)
                        ctype = "application/octet-stream"
                    else:
                        body = encode_png(img, level=png_level)
                        ctype = "image/png"
                except Exception as e:  # surface render errors to the client
                    msg = f"render error: {e}".encode()
                    self.send_response(500)
                    self.send_header("Content-Length", str(len(msg)))
                    self.end_headers()
                    self.wfile.write(msg)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("X-Splat-Overflow", str(overflow))
                self.send_header("X-Splat-W", str(img.shape[1]))
                self.send_header("X-Splat-H", str(img.shape[0]))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)
            else:
                self.send_response(404)
                self.end_headers()

    srv = ThreadingHTTPServer((host, port), Handler)
    print(f"splat_tpu viewer on http://{host}:{srv.server_address[1]}/ "
          f"(N={scene.num_gaussians}, {camera.w}x{camera.h})")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
