"""Point-cloud tessellation (the qhull path of addMeshVertices).
Counterpart of gravit_tpu/scene/tessellate.py, copied (numpy only).

Reference: api.cpp:143-170 runs qhull ("d Qz" by default) over the vertex
cloud and adds every 3-vertex facet as a triangle. Without qhull in this
environment, `convex_hull` provides an incremental 3D hull (the qhull "QJ"
convex case); near-planar clouds additionally get `delaunay_2_5d` — a
Bowyer-Watson triangulation in the dominant plane, which is what "d Qz"
yields for terrain-style inputs (the TessApp use case).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def convex_hull(points: np.ndarray) -> List[Tuple[int, int, int]]:
    """Incremental 3D convex hull; returns CCW-outward triangles (indices).

    O(n*f) — fine for the api's point-cloud sizes. Degenerate (planar)
    input falls back to the 2.5D Delaunay triangulation.
    """
    pts = np.asarray(points, np.float64)
    n = len(pts)
    if n < 4:
        return []

    # find 4 non-coplanar seed points
    i0 = 0
    i1 = int(np.argmax(np.linalg.norm(pts - pts[i0], axis=1)))
    d1 = pts[i1] - pts[i0]
    cr = np.cross(d1, pts - pts[i0])
    i2 = int(np.argmax(np.linalg.norm(cr, axis=1)))
    nrm = np.cross(pts[i1] - pts[i0], pts[i2] - pts[i0])
    if np.linalg.norm(nrm) < 1e-12:
        return delaunay_2_5d(points)
    dist = (pts - pts[i0]) @ nrm
    i3 = int(np.argmax(np.abs(dist)))
    if abs(dist[i3]) < 1e-12 * np.linalg.norm(nrm):
        return delaunay_2_5d(points)

    # orient the seed tetrahedron
    faces = [(i0, i1, i2), (i0, i2, i3), (i0, i3, i1), (i1, i3, i2)]

    def normal(f):
        a, b, c = pts[f[0]], pts[f[1]], pts[f[2]]
        return np.cross(b - a, c - a)

    centroid = (pts[i0] + pts[i1] + pts[i2] + pts[i3]) / 4.0
    faces = [f if normal(f) @ (pts[f[0]] - centroid) > 0
             else (f[0], f[2], f[1]) for f in faces]

    eps = 1e-10 * float(np.max(np.abs(pts)) + 1.0)
    used = {i0, i1, i2, i3}
    for p in range(n):
        if p in used:
            continue
        visible = [f for f in faces
                   if normal(f) @ (pts[p] - pts[f[0]]) > eps]
        if not visible:
            continue
        # horizon = edges of visible faces not shared by two visible faces
        edge_count: dict = {}
        for f in visible:
            for e in ((f[0], f[1]), (f[1], f[2]), (f[2], f[0])):
                k = (min(e), max(e))
                edge_count[k] = edge_count.get(k, [0, e])[0] + 1, \
                    edge_count.get(k, [0, e])[1]
        vis_set = set(visible)
        faces = [f for f in faces if f not in vis_set]
        for (cnt, e) in edge_count.values():
            if cnt == 1:
                faces.append((e[0], e[1], p))
        used.add(p)
    return faces


def delaunay_2_5d(points: np.ndarray) -> List[Tuple[int, int, int]]:
    """Bowyer-Watson Delaunay in the dominant plane of the cloud."""
    pts = np.asarray(points, np.float64)
    c = pts.mean(axis=0)
    _, _, vt = np.linalg.svd(pts - c, full_matrices=False)
    uv = (pts - c) @ vt[:2].T  # (n, 2) in-plane coordinates

    n = len(uv)
    span = float(np.abs(uv).max() + 1.0)
    m = 4.0 * span
    superp = np.array([[-m, -m], [m, -m], [0.0, m]])
    p2 = np.vstack([uv, superp])
    s0, s1, s2 = n, n + 1, n + 2
    tris = [(s0, s1, s2)]

    def circum_ok(t, p):
        ax, ay = p2[t[0]]
        bx, by = p2[t[1]]
        cx, cy = p2[t[2]]
        dx, dy = p2[p]
        mat = np.array([
            [ax - dx, ay - dy, (ax - dx) ** 2 + (ay - dy) ** 2],
            [bx - dx, by - dy, (bx - dx) ** 2 + (by - dy) ** 2],
            [cx - dx, cy - dy, (cx - dx) ** 2 + (cy - dy) ** 2],
        ])
        # orientation-corrected incircle test
        area2 = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
        det = np.linalg.det(mat)
        return (det > 0) if area2 > 0 else (det < 0)

    for p in range(n):
        bad = [t for t in tris if circum_ok(t, p)]
        edge_count: dict = {}
        for t in bad:
            for e in ((t[0], t[1]), (t[1], t[2]), (t[2], t[0])):
                k = (min(e), max(e))
                cnt, first = edge_count.get(k, (0, e))
                edge_count[k] = (cnt + 1, first)
        bad_set = set(bad)
        tris = [t for t in tris if t not in bad_set]
        for cnt, e in edge_count.values():
            if cnt == 1:
                tris.append((e[0], e[1], p))
    return [t for t in tris if max(t) < n]
