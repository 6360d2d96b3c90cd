"""Terminal-native LIVE viewer — the interactive analog of the reference's
GLUT event loop (``include/Misha/Visualization.h:34-141``): a real-time
render loop with orbit / pan / zoom camera manipulation and a keyboard-
callback registry, running in any terminal with no GL/X dependency.

The reference's ``Visualization`` owns a ``std::vector<KeyboardCallBack>``
(key + description + handler, with 'h'-style help printout) and mouse-drag
camera motion dispatched from the GLUT main loop
(``Visualization.h:118-141``, ``SurfaceVisualization.inl:39-100``). The TPU
rebuild is headless-first, so the same interaction model is rebuilt on the
terminal itself:

  * frames are rasterized on the host (vectorized numpy z-buffer painter,
    :func:`render_rgb`) and displayed as 24-bit-color half blocks — each
    character cell carries two vertical pixels via ``'▀'`` with independent
    foreground/background colors, so an ordinary 200x50 terminal is a
    200x100 RGB display refreshing at tens of Hz;
  * keys are read raw (tty cbreak, arrow escape decoding); when stdin is
    not a tty (tests, scripted drives) the SAME dispatch loop reads
    whitespace-separated key tokens, so every interaction is scriptable;
  * callbacks live in a :class:`KeyboardCallBack` registry exactly like the
    reference's, and '?' prints the same style of key/description help
    (``Visualization.h:97-105`` prints callback descriptions).

Camera keys (the reference's mouse drags, ``SurfaceVisualization.inl:74-96``):
left/right or h/l orbit azimuth, up/down or j/k orbit elevation, +/- zoom,
H/J/K/L pan, 'c' saves the camera (JSON, same contract as
:class:`meshopticalflow_tpu_torch.viz.surface.Camera`), 'o' exports a full-
resolution PNG through the offline renderer, 'q' quits.

A jax-free copy of meshopticalflow_tpu/viz/live.py for the PyTorch port
(drift guard: tests/test_torch_host.py::HOST_COPIES); numpy only, besides
the offline renderer's matplotlib for 'o'.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import sys
from typing import Callable, Iterator, Optional, Sequence

import numpy as np

from .surface import Camera, _triangle_shading, render_surface


# ---------------------------------------------------------------------------
# Host rasterizer: vectorized z-buffered triangle fill.
# ---------------------------------------------------------------------------

def render_rgb(verts: np.ndarray, tris: np.ndarray,
               camera: Camera, width: int, height: int,
               face_colors: Optional[np.ndarray] = None,
               vertex_colors: Optional[np.ndarray] = None,
               vfield: Optional[np.ndarray] = None,
               background=(12, 12, 16), zoom: float = 1.0) -> np.ndarray:
    """Rasterize the mesh to an (height, width, 3) uint8 frame.

    A fully vectorized software rasterizer sized for interactive terminal
    resolutions: every triangle is expanded to its candidate pixel rows
    (one ``np.repeat`` over per-triangle bounding boxes), tested with
    barycentric coordinates, and depth-resolved with a back-to-front
    painter write (sorted fancy assignment — later writes win, matching
    the offline renderer's painter order). Runs in milliseconds at
    terminal sizes for the demo meshes, independent of Python-loop costs.
    """
    verts = np.asarray(verts, np.float64)
    tris = np.asarray(tris, np.int64)
    xy, depth = camera.project(verts)

    # Fit the model into the viewport (isotropic, like the offline path),
    # then apply the orbit zoom. Zoom must ride OUTSIDE the fit: any
    # uniform pre-scaling of xy is cancelled by the max(|xy|)
    # normalization below.
    lim = np.abs(xy).max() * 1.05 + 1e-12
    scale = 0.5 * min(width, height) / lim * zoom
    px = xy[:, 0] * scale + width * 0.5
    py = height * 0.5 - xy[:, 1] * scale

    p = np.stack([px, py], axis=1)[tris]                     # (T, 3, 2)
    z = depth[tris].mean(axis=1)                             # (T,)

    if face_colors is None:
        if vertex_colors is not None:
            face_colors = np.asarray(
                vertex_colors, np.float64)[tris].mean(axis=1)
        else:
            face_colors = np.full((len(tris), 3), 178.0)
    shade = _triangle_shading(verts, tris, np.array([0.4, 0.25, 1.0]))
    cols = np.clip(np.asarray(face_colors, np.float64)
                   * shade[:, None], 0, 255).astype(np.uint8)

    # Candidate pixel rows per triangle (bounding boxes, clipped).
    x0 = np.clip(np.floor(p[:, :, 0].min(axis=1)), 0, width - 1).astype(np.int64)
    x1 = np.clip(np.ceil(p[:, :, 0].max(axis=1)), 0, width - 1).astype(np.int64)
    y0 = np.clip(np.floor(p[:, :, 1].min(axis=1)), 0, height - 1).astype(np.int64)
    y1 = np.clip(np.ceil(p[:, :, 1].max(axis=1)), 0, height - 1).astype(np.int64)
    # Cull backfacing-degenerate and off-screen triangles early.
    inside = (p[:, :, 0].max(axis=1) >= 0) & (p[:, :, 0].min(axis=1) < width) \
        & (p[:, :, 1].max(axis=1) >= 0) & (p[:, :, 1].min(axis=1) < height)
    keep = np.nonzero(inside)[0]
    if keep.size == 0:
        return np.full((height, width, 3), background, np.uint8)

    nx = (x1 - x0 + 1)[keep]
    ny = (y1 - y0 + 1)[keep]
    counts = nx * ny
    tri_of = np.repeat(keep, counts)                          # (P,)
    # Per-candidate local pixel index -> (dx, dy) within each bbox.
    off = np.arange(counts.sum()) - np.repeat(
        np.cumsum(counts) - counts, counts)
    nxr = np.repeat(nx, counts)
    dx = off % nxr
    dy = off // nxr
    cx = x0[tri_of] + dx
    cy = y0[tri_of] + dy

    # Barycentric inclusion at pixel centers.
    a = p[tri_of, 0]
    b = p[tri_of, 1]
    c = p[tri_of, 2]
    q = np.stack([cx + 0.5, cy + 0.5], axis=1)
    det = ((b[:, 0] - a[:, 0]) * (c[:, 1] - a[:, 1])
           - (b[:, 1] - a[:, 1]) * (c[:, 0] - a[:, 0]))
    det = np.where(np.abs(det) < 1e-30, 1e-30, det)
    w0 = ((b[:, 0] - q[:, 0]) * (c[:, 1] - q[:, 1])
          - (b[:, 1] - q[:, 1]) * (c[:, 0] - q[:, 0])) / det
    w1 = ((c[:, 0] - q[:, 0]) * (a[:, 1] - q[:, 1])
          - (c[:, 1] - q[:, 1]) * (a[:, 0] - q[:, 0])) / det
    w2 = 1.0 - w0 - w1
    eps = -1e-9
    hit = (w0 >= eps) & (w1 >= eps) & (w2 >= eps)

    tri_of = tri_of[hit]
    cx = cx[hit]
    cy = cy[hit]
    img = np.full((height, width, 3), background, np.uint8)
    if tri_of.size:
        # Painter order: write back-to-front; fancy assignment applies
        # writes in index order so the nearest triangle lands last.
        order = np.argsort(-z[tri_of], kind="stable")
        img[cy[order], cx[order]] = cols[tri_of[order]]

    if vfield is not None:
        _draw_glyphs(img, verts, tris, np.asarray(vfield, np.float64),
                     camera, scale, width, height)
    return img


def _draw_glyphs(img, verts, tris, vfield, camera, scale, width, height,
                 max_glyphs=800):
    """Vector-field glyphs as 2-pixel-step line splats (terminal-scale
    version of the offline LineCollection glyphs)."""
    t_sel = np.arange(len(tris))
    if len(t_sel) > max_glyphs:
        t_sel = t_sel[:: len(t_sel) // max_glyphs]
    e1 = verts[tris[t_sel, 1]] - verts[tris[t_sel, 0]]
    e2 = verts[tris[t_sel, 2]] - verts[tris[t_sel, 0]]
    vec = e1 * vfield[t_sel, 0:1] + e2 * vfield[t_sel, 1:2]
    base = verts[tris[t_sel]].mean(axis=1)
    b_xy, _ = camera.project(base)
    t_xy, _ = camera.project(base + vec)
    steps = 6
    for s in range(steps + 1):
        pt = b_xy + (t_xy - b_xy) * (s / steps)
        x = (pt[:, 0] * scale + width * 0.5).astype(np.int64)
        y = (height * 0.5 - pt[:, 1] * scale).astype(np.int64)
        ok = (x >= 0) & (x < width) & (y >= 0) & (y < height)
        img[y[ok], x[ok]] = (255, 255, 255) if s == steps else (0, 0, 0)


# ---------------------------------------------------------------------------
# Terminal output: 24-bit half-block frames.
# ---------------------------------------------------------------------------

def frame_to_ansi(img: np.ndarray, status: str = "") -> str:
    """Encode an (H, W, 3) uint8 frame as truecolor half-block text.

    Each output row packs two pixel rows: '▀' with the top pixel as the
    foreground color and the bottom pixel as the background color.
    """
    h, w = img.shape[:2]
    if h % 2:
        img = np.concatenate([img, img[-1:]], axis=0)
        h += 1
    top = img[0::2]
    bot = img[1::2]
    rows = []
    for r in range(h // 2):
        cells = []
        last = None
        for ccol in range(w):
            tr, tg, tb = top[r, ccol]
            br, bg, bb = bot[r, ccol]
            key = (tr, tg, tb, br, bg, bb)
            if key != last:
                cells.append(f"\x1b[38;2;{tr};{tg};{tb}m"
                             f"\x1b[48;2;{br};{bg};{bb}m")
                last = key
            cells.append("▀")
        rows.append("".join(cells) + "\x1b[0m")
    out = "\x1b[H" + "\n".join(rows)
    if status:
        out += "\n\x1b[0m\x1b[2K" + status
    return out


class TerminalDisplay:
    """Frame sink: full-screen half-block rendering to a stream (default
    stdout). ``size()`` reports the pixel resolution the terminal offers
    (columns x 2*(rows-1), one row reserved for the status line)."""

    def __init__(self, stream=None, max_width: int = 480):
        self.stream = stream or sys.stdout
        self.max_width = max_width
        self._opened = False

    def size(self):
        ts = shutil.get_terminal_size((100, 40))
        w = min(ts.columns, self.max_width)
        h = 2 * max(ts.lines - 2, 8)
        return w, h

    def open(self):
        if not self._opened:
            self.stream.write("\x1b[?25l\x1b[2J")   # hide cursor, clear
            self._opened = True

    def show(self, img: np.ndarray, status: str = "") -> None:
        self.open()
        self.stream.write(frame_to_ansi(img, status))
        self.stream.flush()

    def close(self):
        if self._opened:
            self.stream.write("\x1b[0m\x1b[?25h\n")  # restore cursor
            self.stream.flush()
            self._opened = False


# ---------------------------------------------------------------------------
# Key input: raw tty when interactive, token stream when scripted.
# ---------------------------------------------------------------------------

_ARROWS = {"A": "up", "B": "down", "C": "right", "D": "left"}


def _tty_keys() -> Iterator[str]:
    """Cbreak key reader with arrow-key escape decoding. A bare ESC press
    yields "escape" immediately: after '\\x1b' the follow-up bytes are only
    consumed if they are already pending (terminals emit a full arrow
    sequence in one burst), so ESC never blocks or swallows the next
    keystroke."""
    import select
    import termios
    import tty

    fd = sys.stdin.fileno()
    old = termios.tcgetattr(fd)

    def _pending(timeout=0.03):
        return bool(select.select([fd], [], [], timeout)[0])

    try:
        tty.setcbreak(fd)
        while True:
            ch = sys.stdin.read(1)
            if not ch:
                return
            if ch == "\x1b":
                if not _pending():
                    yield "escape"
                    continue
                nxt = sys.stdin.read(1)
                if nxt == "[" and _pending():
                    fin = sys.stdin.read(1)
                    yield _ARROWS.get(fin, "escape")
                else:
                    yield "escape"
            else:
                yield ch
    finally:
        termios.tcsetattr(fd, termios.TCSADRAIN, old)


def _token_keys(stream) -> Iterator[str]:
    """Whitespace-separated key tokens (scripted / test drives): multi-char
    tokens name special keys ('up', 'left', ...); single chars are keys."""
    for line in stream:
        for tok in line.split():
            yield tok


# ---------------------------------------------------------------------------
# Callback registry + event loop.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class KeyboardCallBack:
    """Mirror of the reference's callback record
    (``Visualization.h:47-58``): a key, a help description, and a handler.
    Handlers return False to end the loop."""

    key: str
    description: str
    handler: Callable[[], Optional[bool]]


class LiveViewer:
    """The event loop: render -> display -> read key -> dispatch.

    ``color_source()`` returns per-vertex colors (or None) each frame;
    ``vfield_source()`` returns per-triangle chart vectors (or None) —
    both are re-polled every frame so callbacks that mutate viewer state
    (advance a level, page an eigenfield) show up immediately, matching
    the reference's idle/display refresh split.
    """

    def __init__(self, verts, tris, camera: Optional[Camera] = None,
                 color_source: Optional[Callable] = None,
                 vfield_source: Optional[Callable] = None,
                 out_dir: str = ".",
                 display: Optional[TerminalDisplay] = None,
                 key_source: Optional[Iterator[str]] = None,
                 status_source: Optional[Callable[[], str]] = None):
        self.verts = np.asarray(verts, np.float64)
        self.tris = np.asarray(tris, np.int64)
        self.camera = camera or Camera(
            target=tuple(self.verts.mean(axis=0)))
        self.color_source = color_source or (lambda: None)
        self.vfield_source = vfield_source or (lambda: None)
        self.out_dir = out_dir
        self.display = display or TerminalDisplay()
        self.status_source = status_source or (lambda: "")
        self.exports = 0
        self.frames = 0
        self._quit = False
        self._tty = False
        if key_source is not None:
            self._keys = key_source
        elif sys.stdin.isatty():
            self._keys = _tty_keys()
            self._tty = True
        else:
            self._keys = _token_keys(sys.stdin)
        self.callbacks: list[KeyboardCallBack] = []
        self._install_camera_keys()
        self.add_key("o", "export full-res PNG + camera", self._export)
        self.add_key("c", "save camera", self._save_camera)
        self.add_key("?", "print key help", self._help)
        self.add_key("q", "quit", lambda: False)
        # GLUT quits on ESC (Visualization.h KeyboardFunc, key 27).
        self.add_key("escape", "quit", lambda: False)

    # -- registry ----------------------------------------------------------
    def add_key(self, key: str, description: str, handler) -> None:
        self.callbacks.append(KeyboardCallBack(key, description, handler))

    def _install_camera_keys(self):
        cam = self.camera
        step = 0.12

        def orbit(daz, del_):
            def f():
                cam.azimuth += daz
                cam.elevation = float(
                    np.clip(cam.elevation + del_, -1.45, 1.45))
            return f

        def pan(dx, dy):
            def f():
                right, up, _ = cam.axes()
                span = np.ptp(self.verts, axis=0).max()
                t = np.asarray(cam.target, np.float64) \
                    + 0.05 * span * (dx * right + dy * up)
                cam.target = tuple(t)
            return f

        def zoom(f):
            def g():
                cam.distance = float(np.clip(cam.distance * f, 1e-3, 1e6))
            return g

        for key, desc, fn in [
                ("left", "orbit left", orbit(-step, 0)),
                ("right", "orbit right", orbit(step, 0)),
                ("up", "orbit up", orbit(0, step)),
                ("down", "orbit down", orbit(0, -step)),
                ("h", "orbit left", orbit(-step, 0)),
                ("l", "orbit right", orbit(step, 0)),
                ("k", "orbit up", orbit(0, step)),
                ("j", "orbit down", orbit(0, -step)),
                ("+", "zoom in", zoom(1.0 / 1.15)),
                ("-", "zoom out", zoom(1.15)),
                ("H", "pan left", pan(-1, 0)),
                ("L", "pan right", pan(1, 0)),
                ("K", "pan up", pan(0, 1)),
                ("J", "pan down", pan(0, -1)),
        ]:
            self.add_key(key, desc, fn)

    # -- prompts -------------------------------------------------------------
    def prompt(self, label: str) -> str:
        """Read a typed value — the analog of the reference's promptable
        callbacks (Visualization.h read-prompt path feeding e.g.
        ScalarSmoothWeightCallBack's atof(prompt), OpticalFlow.cpp:662-677).
        On a raw tty, characters accumulate until Enter (escape cancels);
        on a token stream, the next token is the value."""
        self.display.stream.write(f"\x1b[0m\n\x1b[2K{label}")
        self.display.stream.flush()
        if self._tty:
            buf = []
            for ch in self._keys:
                if ch in ("\r", "\n"):
                    break
                if ch == "escape":
                    return ""
                buf.append(ch)
                self.display.stream.write(ch)
                self.display.stream.flush()
            return "".join(buf)
        return next(self._keys, "")

    # -- built-in handlers ---------------------------------------------------
    def _export(self):
        os.makedirs(self.out_dir, exist_ok=True)
        path = os.path.join(self.out_dir, f"live_export_{self.exports:03d}.png")
        render_surface(self.verts, self.tris, path,
                       vertex_colors=self.color_source(),
                       vfield=self.vfield_source(), camera=self.camera)
        self.camera.save(os.path.join(self.out_dir, "camera.json"))
        self.exports += 1

    def _save_camera(self):
        os.makedirs(self.out_dir, exist_ok=True)
        self.camera.save(os.path.join(self.out_dir, "camera.json"))

    def _help(self):
        lines = [f"  [{cb.key}] {cb.description}" for cb in self.callbacks]
        self.display.stream.write(
            "\x1b[0m\n" + "\n".join(lines) + "\n")
        self.display.stream.flush()

    # -- frame + loop --------------------------------------------------------
    def _status(self):
        cam = self.camera
        extra = self.status_source()
        return (f"az {cam.azimuth:+.2f} el {cam.elevation:+.2f} "
                f"zoom {3.0 / cam.distance:.2f}x  {extra}  "
                "[?] help  [q] quit")

    def dispatch(self, key: str) -> bool:
        for cb in self.callbacks:
            if cb.key == key:
                return cb.handler() is not False
        return True

    def run(self, max_frames: Optional[int] = None) -> int:
        """Run the loop; returns the number of frames displayed."""
        try:
            self.display.show(self._zoomed_frame(), self._status())
            for key in self._keys:
                if not self.dispatch(key):
                    break
                self.display.show(self._zoomed_frame(), self._status())
                if max_frames is not None and self.frames >= max_frames:
                    break
        finally:
            self.display.close()
        return self.frames

    def _zoomed_frame(self) -> np.ndarray:
        """Render at the display size with the camera's distance mapped to
        the orthographic zoom factor default_distance / distance."""
        w, h = self.display.size()
        img = render_rgb(self.verts, self.tris, self.camera, w, h,
                         vertex_colors=self.color_source(),
                         vfield=self.vfield_source(),
                         zoom=3.0 / max(self.camera.distance, 1e-3))
        self.frames += 1
        return img
