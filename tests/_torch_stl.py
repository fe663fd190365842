"""Synthetic STL meshes and rotation helpers of the port's mesh and MJCF
import tests."""
import struct

import numpy as np


def write_stl(path, verts, faces):
    """A binary STL of triangles verts[faces] (outward winding)."""
    verts = np.asarray(verts, np.float32)
    with open(path, "wb") as f:
        f.write(b"\0" * 80)
        f.write(struct.pack("<I", len(faces)))
        for tri in faces:
            f.write(struct.pack("<3f", 0, 0, 0))
            for i in tri:
                f.write(struct.pack("<3f", *verts[i]))
            f.write(struct.pack("<H", 0))


def box_mesh(lo, hi):
    """Vertices and outward faces of an axis-aligned box."""
    v = np.array([[x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1])
                  for z in (lo[2], hi[2])])
    faces = [(0, 2, 1), (1, 2, 3), (4, 5, 6), (5, 7, 6), (0, 1, 4),
             (1, 5, 4), (2, 6, 3), (3, 6, 7), (0, 4, 2), (2, 4, 6),
             (1, 3, 5), (3, 7, 5)]
    # wind each triangle so that its normal points away from the center
    mid = v.mean(0)
    out = []
    for a, b, c in faces:
        n = np.cross(v[b] - v[a], v[c] - v[a])
        out.append((a, b, c) if n @ (v[a] - mid) > 0 else (a, c, b))
    return v, out


def prism_mesh(poly, center, h):
    """A counter-clockwise polygon, star-shaped about ``center``, extruded
    from z = 0 to h: caps fanned from the center, outward sides."""
    n = len(poly)
    v = ([(x, y, 0.0) for x, y in poly] + [(x, y, h) for x, y in poly]
         + [(center[0], center[1], 0.0), (center[0], center[1], h)])
    c0, c1 = 2 * n, 2 * n + 1
    faces = []
    for i in range(n):
        j = (i + 1) % n
        faces += [(c0, j, i), (c1, n + i, n + j),          # caps
                  (i, j, n + j), (i, n + j, n + i)]        # side
    return np.array(v), faces


def rotation(quat):
    w, x, y, z = quat
    return np.array([[1-2*(y*y+z*z), 2*(x*y-w*z), 2*(x*z+w*y)],
                     [2*(x*y+w*z), 1-2*(x*x+z*z), 2*(y*z-w*x)],
                     [2*(x*z-w*y), 2*(y*z+w*x), 1-2*(x*x+y*y)]])


def tensor(quat, diag):
    R = rotation(quat)
    return R @ np.diag(diag) @ R.T
