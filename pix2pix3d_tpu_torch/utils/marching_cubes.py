"""Marching cubes (numpy, host-side), a copy of
`pix2pix3d_tpu/utils/marching_cubes.py` (same output, bit for bit).

Replacement for the reference's `mcubes.marching_cubes` dependency
(`applications/extract_mesh.py:88,192`).  Standard lookup-table marching
cubes with linear interpolation along edges; vectorized over all cells.
"""

from __future__ import annotations

import functools

import numpy as np

# Edge -> corner pairs of the unit cube.  Corner i has coords
# ((i>>0)&1, (i>>1)&1, (i>>2)&1) in (x, y, z).
_EDGE_CORNERS = np.array([
    (0, 1), (1, 3), (3, 2), (2, 0),
    (4, 5), (5, 7), (7, 6), (6, 4),
    (0, 4), (1, 5), (3, 7), (2, 6)], dtype=np.int64)

_CORNER_OFFSETS = np.array(
    [[(i >> 0) & 1, (i >> 1) & 1, (i >> 2) & 1] for i in range(8)],
    dtype=np.int64)


@functools.cache
def _build_tables():
    """Build the 256-case triangle table by walking each case's surface.

    Uses the classic convex-hull-free construction: for each of the 256
    corner-sign cases, the intersected edges form closed polygons on the cube
    surface; we triangulate them by tracing face adjacency.
    """
    # Face definition: (corner indices, ccw as seen from outside)
    faces = [
        (0, 1, 3, 2),  # z = 0
        (4, 6, 7, 5),  # z = 1
        (0, 4, 5, 1),  # y = 0
        (2, 3, 7, 6),  # y = 1
        (0, 2, 6, 4),  # x = 0
        (1, 5, 7, 3),  # x = 1
    ]
    # edge id lookup by corner pair
    edge_of = {}
    for e, (a, b) in enumerate(_EDGE_CORNERS):
        edge_of[(a, b)] = e
        edge_of[(b, a)] = e

    tri_table = np.full((256, 16), -1, dtype=np.int64)
    for case in range(256):
        inside = [(case >> i) & 1 for i in range(8)]
        # collect directed surface edges: for each face, the segments of the
        # iso-contour crossing it, oriented so inside is on the left
        segments = {}
        for f in faces:
            pts = []
            n = len(f)
            for k in range(n):
                a, b = f[k], f[(k + 1) % n]
                if inside[a] != inside[b]:
                    pts.append((edge_of[(a, b)], inside[a]))
            if len(pts) == 2:
                (e0, in0), (e1, in1) = pts
                # orient: segment goes from the edge whose first corner is
                # inside to the other (keeps consistent winding)
                if in0:
                    segments[e0] = e1
                else:
                    segments[e1] = e0
            elif len(pts) == 4:
                # ambiguous face: connect crossing pairs in order
                (e0, in0), (e1, _), (e2, in2), (e3, _) = pts
                if in0:
                    segments[e0] = e1
                    segments[e2] = e3
                else:
                    segments[e1] = e2
                    segments[e3] = e0
        # trace closed loops and fan-triangulate
        tris = []
        visited = set()
        for start in list(segments):
            if start in visited:
                continue
            loop = [start]
            visited.add(start)
            cur = segments[start]
            while cur != start:
                loop.append(cur)
                visited.add(cur)
                cur = segments[cur]
            for i in range(1, len(loop) - 1):
                tris.extend([loop[0], loop[i], loop[i + 1]])
        tri_table[case, :len(tris)] = tris
    return tri_table


def marching_cubes(volume, threshold):
    """Extract an isosurface mesh from a 3D scalar field.

    Args:
        volume: `[X, Y, Z]` float array.
        threshold: iso value.

    Returns:
        (vertices `[V, 3]` float32 in index coordinates, faces `[F, 3]` int).
    """
    vol = np.asarray(volume, dtype=np.float32)
    nx, ny, nz = vol.shape
    inside = vol > threshold

    # case index per cell
    case = np.zeros((nx - 1, ny - 1, nz - 1), dtype=np.int64)
    for i, (ox, oy, oz) in enumerate(_CORNER_OFFSETS):
        case |= inside[ox:nx - 1 + ox, oy:ny - 1 + oy, oz:nz - 1 + oz].astype(np.int64) << i

    active = np.argwhere((case > 0) & (case < 255))
    if len(active) == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)
    cell_case = case[active[:, 0], active[:, 1], active[:, 2]]

    # interpolated vertex on every active (cell, edge) pair used by tris
    tris = _build_tables()[cell_case]  # [A, 16]
    n_tri_edges = (tris >= 0).sum(axis=1)

    # global edge key: identify shared edges between cells so vertices weld.
    # edge represented by (corner0 grid coords, axis)
    c0 = _EDGE_CORNERS[:, 0]
    c1 = _EDGE_CORNERS[:, 1]
    off0 = _CORNER_OFFSETS[c0]  # [12, 3]
    off1 = _CORNER_OFFSETS[c1]
    axis = np.argmax(off0 != off1, axis=1)  # varying axis per edge
    base = np.minimum(off0, off1)  # lower corner of the edge

    # flatten all (cell, edge) references from the tri table
    flat_cells = np.repeat(np.arange(len(active)), 16)
    flat_edges = tris.reshape(-1)
    valid = flat_edges >= 0
    flat_cells = flat_cells[valid]
    flat_edges = flat_edges[valid]

    cell_xyz = active[flat_cells]  # [T, 3]
    exyz = cell_xyz + base[flat_edges]
    eaxis = axis[flat_edges]
    key = ((exyz[:, 0] * ny + exyz[:, 1]) * nz + exyz[:, 2]) * 3 + eaxis

    uniq, inv = np.unique(key, return_inverse=True)

    # interpolate unique vertices
    ux = uniq // (3 * nz * ny)
    rem = uniq % (3 * nz * ny)
    uy = rem // (3 * nz)
    rem = rem % (3 * nz)
    uz = rem // 3
    ua = rem % 3
    p0 = np.stack([ux, uy, uz], axis=1)
    step = np.eye(3, dtype=np.int64)[ua]
    p1 = p0 + step
    v0 = vol[p0[:, 0], p0[:, 1], p0[:, 2]]
    v1 = vol[p1[:, 0], p1[:, 1], p1[:, 2]]
    t = np.clip((threshold - v0) / np.where(v1 == v0, 1, v1 - v0), 0, 1)
    verts = p0.astype(np.float32) + t[:, None] * step.astype(np.float32)

    faces = inv.reshape(-1, 3)
    return verts, faces
