"""Host-side rendering of planar- and spatial-engine models.

Counterpart of ``icem_tpu/envs/physics/render.py``. The reference records
videos from MuJoCo's renderer (icem/misc/rollout_utils.py:70-81, :174-183);
here a frame is the kinematic skeleton drawn on the host from a numpy copy
of the state: the ground line with a tick every metre, the bones from each
parent's origin to its child's, the root as a dot and the contact geoms as
circles to scale. The JAX package rasterizes with matplotlib; this module
draws the same scene in numpy at the same pixels — a ``width`` x ``height``
frame whose plot box is matplotlib's default subplot box at 100 dpi, with
equal axes, a view ``window`` metres wide centred on the root and the
ground 0.3 m above the box's bottom — in the same colours and line widths,
without anti-aliasing. Rendering never touches the device hot path.
"""

from __future__ import annotations

import numpy as np

# matplotlib's defaults that place the JAX package's plot: the subplot box
# (figure.subplot.left/right/bottom/top), points per inch and the dpi
_BOX = (0.125, 0.9, 0.11, 0.88)
_DPI = 100.0
_PT = _DPI / 72.0                      # pixels per point

_GROUND = (0x88, 0x88, 0x88)
_TICK = (0xbb, 0xbb, 0xbb)
_BONE = (0x2c, 0x6f, 0xbb)
_ROOT = (0x1a, 0x3a, 0x5c)
_GEOM = (0xd9, 0x5f, 0x02)


def _fk_host(model, q):
    """Numpy forward kinematics (mirrors physics.planar.fk, host-side)."""
    q = np.asarray(q, np.float64)
    B = model.nbody
    anchors = np.asarray(model.anchor, np.float64)
    origins = np.zeros((B, 2))
    angles = np.zeros(B)
    for b in range(B):
        if b == 0:
            if model.free_root:
                angles[0] = q[2]
                origins[0] = q[0:2] + anchors[0]
            else:
                angles[0] = q[0]
                origins[0] = anchors[0]
        else:
            pa = model.parent[b]
            pang = angles[pa]
            c, s = np.cos(pang), np.sin(pang)
            rot = np.array([[c, -s], [s, c]])
            angles[b] = pang + q[model.dof_of_body(b)]
            origins[b] = origins[pa] + rot @ anchors[b]
    geom_pts = np.zeros((len(model.geom_body), 2))
    for g, b in enumerate(model.geom_body):
        c, s = np.cos(angles[b]), np.sin(angles[b])
        rot = np.array([[c, -s], [s, c]])
        geom_pts[g] = origins[b] + rot @ np.asarray(model.geom_pos[g], np.float64)
    return origins, angles, geom_pts


def _fk_host_spatial(model, q):
    """Numpy forward kinematics (mirrors physics.spatial.fk, host-side)."""
    q = np.asarray(q, np.float64)
    B = model.nbody
    anchors = np.asarray(model.anchor, np.float64)
    axes = np.asarray(model.axis, np.float64)
    origins = np.zeros((B, 3))
    rots = np.zeros((B, 3, 3))

    def rot_axis(a, th):
        K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
        return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)

    for b in range(B):
        if b == 0:
            if model.free_root:
                r, p, y = q[3], q[4], q[5]
                Rx = rot_axis(np.array([1.0, 0, 0]), r)
                Ry = rot_axis(np.array([0, 1.0, 0]), p)
                Rz = rot_axis(np.array([0, 0, 1.0]), y)
                rots[0] = np.asarray(getattr(model, "root_rot_offset", np.eye(3)),
                                     np.float64) @ (Rz @ Ry @ Rx)
                origins[0] = q[0:3] + anchors[0]
            else:
                rots[0] = rot_axis(axes[0], q[0])
                origins[0] = anchors[0]
        else:
            pa = model.parent[b]
            rots[b] = rots[pa] @ rot_axis(axes[b], q[model.dof_of_body(b)])
            origins[b] = origins[pa] + rots[pa] @ anchors[b]
    geom_pts = np.zeros((len(model.geom_body), 3))
    for g, b in enumerate(model.geom_body):
        geom_pts[g] = origins[b] + rots[b] @ np.asarray(model.geom_pos[g], np.float64)
    return origins, rots, geom_pts


class _Canvas:
    """A white frame with the plot box of the JAX package's figure: data
    (x, y) in metres maps to pixels by one scale, and every mark is clipped
    to the box."""

    def __init__(self, width: int, height: int, window: float, cx: float):
        self.img = np.full((height, width, 3), 255, np.uint8)
        self.height = height
        left, right, bottom, top = _BOX
        box_w, box_h = (right - left) * width, (top - bottom) * height
        data_h = window * height / width
        # equal aspect: the box shrinks about its centre to the data's ratio
        self.scale = min(box_w / window, box_h / data_h)
        w, h = self.scale * window, self.scale * data_h
        self.x0 = left * width + (box_w - w) / 2         # pixels from the left
        self.y0 = bottom * height + (box_h - h) / 2      # pixels from the bottom
        self.box = (self.x0, self.x0 + w, self.y0, self.y0 + h)
        self.xlo, self.ylo = cx - window / 2, -0.3

    def px(self, p):
        """Data (x, y) -> display pixels (from the left, from the bottom)."""
        return (self.x0 + self.scale * (p[0] - self.xlo),
                self.y0 + self.scale * (p[1] - self.ylo))

    def _paint(self, lo, hi, inside, color):
        """Colour the pixels whose centres (display coordinates) within the
        box [lo, hi] satisfy ``inside(x, y)``."""
        bx0, bx1, by0, by1 = self.box
        c0, c1 = int(np.floor(max(lo[0], bx0))), int(np.ceil(min(hi[0], bx1)))
        y0, y1 = int(np.floor(max(lo[1], by0))), int(np.ceil(min(hi[1], by1)))
        if c1 <= c0 or y1 <= y0:
            return
        xs = np.arange(c0, c1) + 0.5
        ys = np.arange(y1 - 1, y0 - 1, -1) + 0.5         # top row first
        X, Y = np.meshgrid(xs, ys)
        mask = inside(X, Y) & (X >= bx0) & (X <= bx1) & (Y >= by0) & (Y <= by1)
        # display pixel j from the bottom is image row height - 1 - j
        self.img[self.height - y1: self.height - y0, c0:c1][mask] = color

    def segment(self, p0, p1, lw_pt: float, color):
        """A line of ``lw_pt`` points with round ends."""
        (ax, ay), (bx, by) = self.px(p0), self.px(p1)
        r = lw_pt * _PT / 2
        dx, dy = bx - ax, by - ay
        n2 = max(dx * dx + dy * dy, 1e-12)

        def inside(X, Y):
            t = np.clip(((X - ax) * dx + (Y - ay) * dy) / n2, 0.0, 1.0)
            return (X - ax - t * dx) ** 2 + (Y - ay - t * dy) ** 2 <= r * r

        self._paint((min(ax, bx) - r, min(ay, by) - r), (max(ax, bx) + r, max(ay, by) + r),
                    inside, color)

    def hline(self, y: float, lw_pt: float, color):
        """A horizontal line across the whole box."""
        _, py = self.px((self.xlo, y))
        r = lw_pt * _PT / 2
        self._paint((self.box[0], py - r), (self.box[1], py + r),
                    lambda X, Y: np.abs(Y - py) <= r, color)

    def disc(self, c, diameter_pt: float, color):
        cx, cy = self.px(c)
        r = diameter_pt * _PT / 2
        self._paint((cx - r, cy - r), (cx + r, cy + r),
                    lambda X, Y: (X - cx) ** 2 + (Y - cy) ** 2 <= r * r, color)

    def ring(self, c, radius: float, lw_pt: float, color):
        """A circle of ``radius`` metres, its outline ``lw_pt`` points wide."""
        cx, cy = self.px(c)
        R, half = radius * self.scale, lw_pt * _PT / 2
        self._paint((cx - R - half, cy - R - half), (cx + R + half, cy + R + half),
                    lambda X, Y: np.abs(np.hypot(X - cx, Y - cy) - R) <= half, color)


def _draw(points, parent, geom_pts, geom_radius, width, height, window) -> np.ndarray:
    """The scene of a pose: body origins ``points`` [B, 2] and geom centres
    [G, 2] in the plane of the picture."""
    cx = float(points[0, 0])
    cv = _Canvas(width, height, window, cx)
    # matplotlib draws patches (the geoms) under lines, lines in the order
    # they were added
    for g in range(len(geom_pts)):
        cv.ring(geom_pts[g], float(geom_radius[g]), 1.5, _GEOM)
    cv.hline(0.0, 1.5, _GROUND)
    for x_tick in np.arange(np.floor(cx - window), np.ceil(cx + window)):
        cv.segment((x_tick, 0.0), (x_tick, -0.08), 1.0, _TICK)
    for b in range(1, len(parent)):
        cv.segment(points[parent[b]], points[b], 3.0, _BONE)
    # a marker of 8 points with an edge of 1 point in the same colour
    cv.disc(points[0], 8.0 + 1.0, _ROOT)
    return cv.img


def render_planar(model, q, *, width: int = 480, height: int = 320,
                  window: float = 3.0) -> np.ndarray:
    """Rasterize one frame of a PlanarModel pose. Returns uint8 [H, W, 3]."""
    origins, _, geom_pts = _fk_host(model, q)
    return _draw(origins, model.parent, geom_pts, model.geom_radius, width, height, window)


def render_spatial_xz(model, q, *, width: int = 480, height: int = 320,
                      window: float = 3.0) -> np.ndarray:
    """Sagittal (x, z) wireframe of a SpatialModel pose. Returns uint8 [H,W,3]."""
    origins, _, geom_pts = _fk_host_spatial(model, q)
    return _draw(origins[:, [0, 2]], model.parent, geom_pts[:, [0, 2]], model.geom_radius,
                 width, height, window)
