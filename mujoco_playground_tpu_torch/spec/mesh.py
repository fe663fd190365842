"""STL mesh ingestion: mass properties, principal frames, convex hulls (the
port of the JAX package's ``spec/mesh.py``; host numpy and scipy).

Gives the MJCF importer (``spec/mjcf_import.py``) end-to-end ``<mesh>``
support without MuJoCo: the mass properties follow MuJoCo 3.10's compiler
for all four of its mesh-inertia modes (held against ``mujoco`` on
synthetic convex, non-convex and multi-component meshes in
tests/test_torch_mesh.py).

Modes (MJCF ``<mesh inertia=...>``; MuJoCo's default is **legacy**):

* ``legacy`` — two passes of absolute-volume tetrahedra: (1) CoM = the
  |vol|-weighted tet-centroid with apex at the area-weighted SURFACE
  centroid; (2) volume + inertia from tets re-rooted at that CoM.
  Abs-volumes make it inexact for shapes non-starlike about the CoM
  (MuJoCo documents this); it is what the reference models compile with.
* ``exact`` — signed divergence-theorem volume/CoM/inertia (correct for
  any watertight, consistently-oriented mesh).
* ``convex`` — exact, applied to the convex hull of the vertices.
* ``shell`` — surface (area) density instead of volume density.

The hull machinery follows the collision layer's contract: a convex-hull
vertex cloud plus triangle faces (spec.types.GeomSpec.hull/hull_faces).
"""
from __future__ import annotations

import struct
from typing import Optional, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# STL loading
# ---------------------------------------------------------------------------

def load_stl(path: str) -> np.ndarray:
    """Triangles (n, 3, 3) float64 from a binary or ASCII STL file."""
    with open(path, "rb") as f:
        data = f.read()
    # ASCII STLs start with "solid" AND parse as text; some binary files
    # also start with "solid", so sniff by record arithmetic first.
    if len(data) >= 84:
        n = struct.unpack("<I", data[80:84])[0]
        if len(data) == 84 + 50 * n:
            rec = np.frombuffer(
                data[84:84 + 50 * n],
                dtype=np.dtype([("n", "<3f4"), ("v", "<9f4"), ("a", "<u2")]))
            return rec["v"].reshape(-1, 3, 3).astype(np.float64)
    text = data.decode("ascii", errors="ignore")
    if not text.lstrip().lower().startswith("solid"):
        raise ValueError(f"{path}: not a valid STL (bad binary record "
                         f"count and no ASCII 'solid' header)")
    verts = []
    for line in text.splitlines():
        parts = line.split()
        if parts[:1] == ["vertex"]:
            verts.append([float(x) for x in parts[1:4]])
    tris = np.asarray(verts, np.float64)
    if tris.size == 0 or len(tris) % 3:
        raise ValueError(f"{path}: malformed ASCII STL")
    return tris.reshape(-1, 3, 3)


# ---------------------------------------------------------------------------
# Mass properties (MuJoCo-compiler-equivalent)
# ---------------------------------------------------------------------------

def _tet_covariance(tris_rel: np.ndarray, weights: np.ndarray) -> np.ndarray:
    """Sum of solid-tetrahedron covariances (apex at origin), tet i weighted
    by ``weights[i]`` (= 6 x its volume).  Canonical-tet integral:
    C = (vol/20) (sum_k v_k v_k^T + s s^T), s = v0+v1+v2."""
    s = tris_rel.sum(axis=1)                                   # (n, 3)
    C = np.einsum("n,nki,nkj->ij", weights, tris_rel, tris_rel)
    C += np.einsum("n,ni,nj->ij", weights, s, s)
    return C / (6.0 * 20.0)


def _signed_vol6(tris_rel: np.ndarray) -> np.ndarray:
    v0, v1, v2 = tris_rel[:, 0], tris_rel[:, 1], tris_rel[:, 2]
    return np.einsum("ij,ij->i", v0, np.cross(v1 - v0, v2 - v0))


def mesh_mass_properties(tris: np.ndarray, mass: Optional[float] = None,
                         density: float = 1000.0, mode: str = "legacy"
                         ) -> Tuple[float, np.ndarray, np.ndarray]:
    """(mass, com(3,), inertia(3,3) about the CoM) of a triangle soup.

    ``mode`` in {legacy, exact, convex, shell} — see module docstring.
    ``mass`` overrides ``density`` (MJCF geom mass/density semantics).
    """
    tris = np.asarray(tris, np.float64)
    if mode == "convex":
        hull_verts, faces = convex_hull(tris.reshape(-1, 3))
        tris = hull_verts[faces]
        mode = "exact"

    if mode == "shell":
        v0, v1, v2 = tris[:, 0], tris[:, 1], tris[:, 2]
        area2 = np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=1)
        A = area2.sum() / 2.0
        com = ((v0 + v1 + v2) / 3.0
               * (area2 / 2.0)[:, None]).sum(0) / A
        t = tris - com
        # triangle lamina covariance: C = (area/12)(sum v v^T + s s^T)
        s = t.sum(axis=1)
        C = (np.einsum("n,nki,nkj->ij", area2 / 2.0, t, t)
             + np.einsum("n,ni,nj->ij", area2 / 2.0, s, s)) / 12.0
        I = np.trace(C) * np.eye(3) - C
        m = mass if mass is not None else density * A
        return m, com, I * (m / A)

    if mode == "exact":
        vol6 = _signed_vol6(tris)
        V = vol6.sum() / 6.0
        if V <= 0:
            raise ValueError("exact mesh inertia needs positive signed "
                             "volume (closed, outward-oriented mesh)")
        com = (tris.sum(axis=1) / 4.0
               * vol6[:, None]).sum(0) / (6.0 * V)
        t = tris - com
        C = _tet_covariance(t, _signed_vol6(t))
        I = np.trace(C) * np.eye(3) - C
        m = mass if mass is not None else density * V
        return m, com, I * (m / V)

    if mode != "legacy":
        raise ValueError(f"unknown mesh inertia mode {mode!r}")

    # legacy (MuJoCo default): pass 1 — CoM from |vol| tets rooted at the
    # area-weighted surface centroid; pass 2 — volume + inertia from |vol|
    # tets re-rooted at that CoM.
    v0, v1, v2 = tris[:, 0], tris[:, 1], tris[:, 2]
    area2 = np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=1)
    apex = ((v0 + v1 + v2) / 3.0
            * (area2 / 2.0)[:, None]).sum(0) / (area2.sum() / 2.0)
    t = tris - apex
    w = np.abs(_signed_vol6(t))
    com = (t.sum(axis=1) / 4.0 * w[:, None]).sum(0) / w.sum() + apex
    t2 = tris - com
    w2 = np.abs(_signed_vol6(t2))
    V = w2.sum() / 6.0
    C = _tet_covariance(t2, w2)
    I = np.trace(C) * np.eye(3) - C
    m = mass if mass is not None else density * V
    return m, com, I * (m / V)


def principal_frame(I: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(diaginertia(3,) descending, quat wxyz) of a symmetric inertia.

    The frame satisfies R diag(d) R^T = I with R right-handed; eigenvector
    signs are canonicalized (largest-|component| positive, det fixed on the
    last axis) for reproducibility.  MuJoCo's own sign convention differs
    by a possible 180-degree flip — physically identical (the engine only
    consumes R diag R^T).
    """
    Is = 0.5 * (I + I.T)
    w, V = np.linalg.eigh(Is)
    order = np.argsort(w)[::-1]
    w, V = w[order], V[:, order]
    for c in range(3):
        k = int(np.argmax(np.abs(V[:, c])))
        if V[k, c] < 0:
            V[:, c] = -V[:, c]
    if np.linalg.det(V) < 0:
        V[:, 2] = -V[:, 2]
    return w, mat_to_quat(V)


def mat_to_quat(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> quaternion (w, x, y, z), w >= 0."""
    tr = R[0, 0] + R[1, 1] + R[2, 2]
    if tr > 0:
        s = 2.0 * np.sqrt(tr + 1.0)
        q = np.array([s / 4.0, (R[2, 1] - R[1, 2]) / s,
                      (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = 2.0 * np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 0.0))
        q = np.zeros(4)
        q[0] = (R[k, j] - R[j, k]) / s
        q[1 + i] = s / 4.0
        q[1 + j] = (R[j, i] + R[i, j]) / s
        q[1 + k] = (R[k, i] + R[i, k]) / s
    if q[0] < 0:
        q = -q
    return q / np.linalg.norm(q)


# ---------------------------------------------------------------------------
# Convex hull
# ---------------------------------------------------------------------------

def convex_hull(verts: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(hull_verts (m, 3), faces (f, 3) indices into hull_verts) with
    outward-oriented triangles, by qhull through scipy; the
    collision narrowphase consumes the vertex cloud, the faces feed the
    ``compat_flat_manifold`` support-face manifold."""
    from scipy.spatial import ConvexHull
    verts = np.unique(np.asarray(verts, np.float64).reshape(-1, 3), axis=0)
    hull = ConvexHull(verts)
    used = np.asarray(hull.vertices)
    remap = np.full(len(verts), -1, np.int64)
    remap[used] = np.arange(len(used))
    faces = remap[hull.simplices]
    hv = verts[used]
    # orient each simplex to match qhull's outward facet normal
    tri = hv[faces]
    nrm = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    flip = np.einsum("ij,ij->i", nrm, hull.equations[:, :3]) < 0
    faces[flip] = faces[flip][:, [0, 2, 1]]
    return hv, faces
