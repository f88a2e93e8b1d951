"""Headless training report — the stand-in for the reference's optional
Pangolin visualizer (visualizer.{hpp,cpp}, -DUSE_VISUALIZATION):
loss/PSNR/population curves + render-vs-GT snapshots, written as a
self-contained HTML file. The port's copy of
opensplat_tpu/utils/report.py; its PNGs come from the port's own encoder
(data/_image.py), so it needs numpy alone.
"""
from __future__ import annotations

import base64
import html
import os
from typing import List, Optional

import numpy as np

from ..data._image import encode_png


def _svg_curve(xs, ys, title, width=640, height=180, color="#2563eb"):
    if len(xs) < 2:
        return f"<p>{html.escape(title)}: not enough data</p>"
    x0, x1 = min(xs), max(xs)
    finite = [y for y in ys if np.isfinite(y)]
    if not finite:
        return f"<p>{html.escape(title)}: no finite data</p>"
    y0, y1 = min(finite), max(finite)
    if y1 == y0:
        y1 = y0 + 1.0
    pts = []
    for x, y in zip(xs, ys):
        if not np.isfinite(y):
            continue
        px = 40 + (x - x0) / (x1 - x0) * (width - 50)
        py = height - 20 - (y - y0) / (y1 - y0) * (height - 40)
        pts.append(f"{px:.1f},{py:.1f}")
    return (
        f'<h3>{html.escape(title)}</h3>'
        f'<svg width="{width}" height="{height}" '
        f'style="background:#f8fafc;border:1px solid #e2e8f0">'
        f'<text x="4" y="14" font-size="11">{y1:.4g}</text>'
        f'<text x="4" y="{height - 6}" font-size="11">{y0:.4g}</text>'
        f'<text x="{width - 60}" y="{height - 6}" font-size="11">step {x1}</text>'
        f'<polyline fill="none" stroke="{color}" stroke-width="1.5" '
        f'points="{" ".join(pts)}"/></svg>'
    )


def _png_b64(img: np.ndarray) -> str:
    rgb = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    return base64.b64encode(encode_png(rgb)).decode()


class TrainingReport:
    """Accumulates curves + snapshots; write() emits one HTML file."""

    def __init__(self, out_dir: str, max_snapshots: int = 12):
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self.steps: List[int] = []
        self.losses: List[float] = []
        self.psnrs: List[float] = []
        self.counts: List[int] = []
        self.snapshots: List[dict] = []
        self.max_snapshots = max_snapshots

    def log(self, step: int, loss: float, psnr: float, n_gaussians: int):
        self.steps.append(step)
        self.losses.append(float(loss))
        self.psnrs.append(float(psnr))
        self.counts.append(int(n_gaussians))

    def snapshot(self, step: int, render: np.ndarray,
                 gt: Optional[np.ndarray] = None):
        if len(self.snapshots) >= self.max_snapshots:
            # keep first/last-heavy coverage: drop the middle entry
            self.snapshots.pop(len(self.snapshots) // 2)
        self.snapshots.append(
            {"step": step, "render": _png_b64(render),
             "gt": _png_b64(gt) if gt is not None else None}
        )

    def point_cloud(self, step: int, means: np.ndarray, colors: np.ndarray,
                    max_points: int = 20000):
        """Live Gaussian point cloud (means colored by SH0 RGB) — the
        3D scene view of the reference's Pangolin visualizer
        (visualizer.cpp:1-179), rendered client-side by a tiny inline
        canvas orbiter (drag to rotate, wheel to zoom; no external JS —
        the page stays self-contained/offline)."""
        means = np.asarray(means, np.float32)
        colors = np.asarray(colors, np.float32)
        n = means.shape[0]
        if n > max_points:
            idx = np.random.default_rng(0).choice(n, max_points, replace=False)
            means, colors = means[idx], colors[idx]
        center = means.mean(axis=0)
        scale = float(np.abs(means - center).max() + 1e-9)
        q = np.clip((means - center) / scale, -1, 1)
        pts16 = (q * 32767).astype(np.int16)
        col8 = np.clip(colors * 255, 0, 255).astype(np.uint8)
        self._cloud = {
            "step": step,
            "n": int(means.shape[0]),
            "pts": base64.b64encode(pts16.tobytes()).decode(),
            "col": base64.b64encode(col8.tobytes()).decode(),
        }

    _cloud: Optional[dict] = None

    def _cloud_html(self) -> str:
        c = self._cloud
        if not c:
            return ""
        return f"""
<h3>Gaussian point cloud (step {c['step']}, {c['n']} shown) —
drag to orbit, wheel to zoom</h3>
<canvas id="pc" width="640" height="480"
 style="background:#0b1020;border:1px solid #e2e8f0"></canvas>
<script>
(function() {{
  const b64 = s => Uint8Array.from(atob(s), ch => ch.charCodeAt(0));
  const pts = new Int16Array(b64("{c['pts']}").buffer);
  const col = b64("{c['col']}");
  const n = pts.length / 3;
  const cv = document.getElementById("pc"), ctx = cv.getContext("2d");
  let rx = -0.4, ry = 0.6, zoom = 1.4, drag = null;
  function draw() {{
    ctx.fillStyle = "#0b1020"; ctx.fillRect(0, 0, cv.width, cv.height);
    const img = ctx.getImageData(0, 0, cv.width, cv.height), d = img.data;
    const cx = Math.cos(rx), sx = Math.sin(rx),
          cy = Math.cos(ry), sy = Math.sin(ry);
    const w = cv.width, h = cv.height, f = 0.45 * Math.min(w, h) * zoom;
    for (let i = 0; i < n; i++) {{
      const x0 = pts[3*i] / 32767, y0 = pts[3*i+1] / 32767,
            z0 = pts[3*i+2] / 32767;
      const x1 = cy * x0 + sy * z0, z1 = -sy * x0 + cy * z0;
      const y2 = cx * y0 - sx * z1, z2 = sx * y0 + cx * z1;
      const zc = z2 + 3.0;
      if (zc < 0.2) continue;
      const px = (w / 2 + f * x1 / zc) | 0, py = (h / 2 - f * y2 / zc) | 0;
      if (px < 0 || py < 0 || px >= w || py >= h) continue;
      const o = 4 * (py * w + px);
      d[o] = col[3*i]; d[o+1] = col[3*i+1]; d[o+2] = col[3*i+2]; d[o+3] = 255;
    }}
    ctx.putImageData(img, 0, 0);
  }}
  cv.onmousedown = e => drag = [e.clientX, e.clientY];
  window.onmouseup = () => drag = null;
  window.onmousemove = e => {{
    if (!drag) return;
    ry += (e.clientX - drag[0]) * 0.01; rx += (e.clientY - drag[1]) * 0.01;
    drag = [e.clientX, e.clientY]; draw();
  }};
  cv.onwheel = e => {{ e.preventDefault();
    zoom *= e.deltaY < 0 ? 1.1 : 0.9; draw(); }};
  draw();
}})();
</script>"""

    _CONTROLS = """
<p>
<button onclick="ctl('pause')">Pause</button>
<button onclick="ctl('resume')">Resume</button>
<button onclick="ctl('stop')">Stop + save</button>
<span id="ctlmsg"></span>
</p>
<script>
function ctl(cmd) {
  fetch('/__control__', {method: 'POST', body: cmd}).then(r =>
    document.getElementById('ctlmsg').textContent =
      r.ok ? ' -> ' + cmd : ' control channel unavailable');
}
</script>"""

    def write(self, filename: str = "report.html", live: bool = False) -> str:
        """live=True adds an auto-refresh tag: rewritten every few dozen
        steps by the CLI (and optionally served via --serve), the page
        becomes a during-training view — the headless upgrade of the
        reference's interactive visualizer window (visualizer.cpp)."""
        parts = [
            "<!doctype html><meta charset='utf-8'>",
            "<meta http-equiv='refresh' content='5'>" if live else "",
            "<title>opensplat_tpu_torch training report</title>",
            "<body style='font-family:system-ui;max-width:720px;margin:2em auto'>",
            "<h1>Training report</h1>" + (
                " <p><i>live — refreshes every 5 s</i></p>" if live else ""
            ),
        ]
        if live:
            # pause/stop control channel (visualizer.cpp:184-195's pause/
            # quit hooks): buttons POST to the CLI's --serve handler,
            # which writes <report_dir>/control.txt; the train loop polls
            # it (works file-only too: `echo stop > control.txt`)
            parts.append(self._CONTROLS)
        parts.append(self._cloud_html())
        if self.steps:
            parts.append(
                f"<p>{self.steps[-1]} steps · final loss "
                f"{self.losses[-1]:.5f} · final PSNR {self.psnrs[-1]:.2f} dB "
                f"· {self.counts[-1]} gaussians</p>"
            )
            parts.append(_svg_curve(self.steps, self.losses, "Loss"))
            parts.append(_svg_curve(self.steps, self.psnrs, "PSNR (dB)",
                                    color="#16a34a"))
            parts.append(_svg_curve(self.steps, self.counts, "Gaussians",
                                    color="#9333ea"))
        if self.snapshots:
            parts.append("<h3>Render vs ground truth</h3>")
            for s in self.snapshots:
                parts.append(f"<div><b>step {s['step']}</b><br>")
                parts.append(
                    f'<img src="data:image/png;base64,{s["render"]}" '
                    f'style="max-width:320px">'
                )
                if s["gt"]:
                    parts.append(
                        f'<img src="data:image/png;base64,{s["gt"]}" '
                        f'style="max-width:320px">'
                    )
                parts.append("</div>")
        parts.append("</body>")
        path = os.path.join(self.out_dir, filename)
        with open(path, "w") as f:
            f.write("\n".join(parts))
        return path
