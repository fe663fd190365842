"""Native (C) model-compile helpers, loaded through ctypes: the port of the
JAX package's ``native/``.

``stl_mass.c`` is compiled at first use with the system C compiler (``CC``,
default ``cc``) into ``build/native/`` beside the package, named by a hash
of the source and the compiler, so an edit or another compiler rebuilds and
an unchanged tree loads what is there.  The library is written under a
temporary name and moved into place, so processes that build at once never
load a half-written file.  Nothing falls back: a failed build or call
raises, with the compiler's output; a caller who wants numpy calls
``stl_mass_properties_numpy``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "stl_mass.c"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CFLAGS = ("-O2", "-shared", "-fPIC")

_LOADED: dict = {}


class _MassProps(ctypes.Structure):
    _fields_ = [
        ("volume", ctypes.c_double),
        ("com", ctypes.c_double * 3),
        ("inertia", ctypes.c_double * 9),
        ("aabb", ctypes.c_double * 6),
        ("n_triangles", ctypes.c_int32),
    ]


def _compiler() -> str:
    return os.environ.get("CC", "cc")


def library_path() -> Path:
    """Where the library of this source and compiler lives."""
    h = hashlib.sha256(f"{_compiler()} {CFLAGS}".encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libstl_mass-{h.hexdigest()[:16]}.so"


def _load() -> ctypes.CDLL:
    """The loaded library, built first if missing; raises if the build
    fails."""
    path = library_path()
    lib = _LOADED.get(path)
    if lib is not None:
        return lib
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_compiler(), *CFLAGS, "-o", str(tmp), str(SOURCE)]
        try:
            out = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"building {SOURCE.name} failed: "
                               f"{' '.join(cmd)}: {e}") from e
        if out.returncode != 0 or not tmp.exists():
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"building {SOURCE.name} failed (exit {out.returncode}): "
                f"{' '.join(cmd)}\n{out.stderr}{out.stdout}")
        os.replace(tmp, path)
    lib = ctypes.CDLL(str(path))
    lib.stl_mass_properties_file.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(_MassProps)]
    lib.stl_mass_properties_file.restype = ctypes.c_int
    _LOADED[path] = lib
    return lib


def stl_mass_properties(path: str):
    """(volume, com(3,), inertia(3,3) about the CoM at unit density,
    aabb(2,3), n_triangles) of a binary STL, by the C library.  Raises if
    the library cannot be built or the file cannot be read."""
    props = _MassProps()
    rc = _load().stl_mass_properties_file(os.fsencode(path),
                                          ctypes.byref(props))
    if rc != 0:
        raise RuntimeError(f"stl_mass_properties({path!r}): error {rc} "
                           f"(-10 open, -11/-12 read, -1/-2 not a binary "
                           f"STL)")
    return (float(props.volume), np.array(props.com),
            np.array(props.inertia).reshape(3, 3),
            np.array(props.aabb).reshape(2, 3), int(props.n_triangles))


def stl_mass_properties_numpy(path: str):
    """The numpy twin of ``stl_mass_properties`` (the same signed-
    tetrahedron algorithm)."""
    with open(path, "rb") as f:
        data = f.read()
    n = int(np.frombuffer(data[80:84], dtype=np.uint32)[0])
    rec = np.frombuffer(data[84:84 + n * 50], dtype=np.uint8).reshape(n, 50)
    tri = rec[:, 12:48].copy().view(np.float32).reshape(n, 3, 3).astype(
        np.float64)
    a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
    vol_t = np.einsum('ij,ij->i', a, np.cross(b, c)) / 6.0
    volume = vol_t.sum()
    com = (vol_t[:, None] * (a + b + c) / 4.0).sum(0) / volume

    def moment(i, j):
        s = (a[:, i] * a[:, j] + b[:, i] * b[:, j] + c[:, i] * c[:, j]
             + 0.5 * (a[:, i] * b[:, j] + a[:, j] * b[:, i]
                      + a[:, i] * c[:, j] + a[:, j] * c[:, i]
                      + b[:, i] * c[:, j] + b[:, j] * c[:, i]))
        return (vol_t / 10.0 * s).sum()

    xx = moment(0, 0) - volume * com[0] ** 2
    yy = moment(1, 1) - volume * com[1] ** 2
    zz = moment(2, 2) - volume * com[2] ** 2
    xy = moment(0, 1) - volume * com[0] * com[1]
    yz = moment(1, 2) - volume * com[1] * com[2]
    zx = moment(2, 0) - volume * com[2] * com[0]
    inertia = np.array([
        [yy + zz, -xy, -zx],
        [-xy, xx + zz, -yz],
        [-zx, -yz, xx + yy],
    ])
    aabb = np.stack([tri.reshape(-1, 3).min(0), tri.reshape(-1, 3).max(0)])
    return volume, com, inertia, aabb, n


def mesh_inertial(path: str, mass: float):
    """InertialSpec-style tuple for a mesh with the given total mass:
    (mass, com, principal quat [w,x,y,z], principal diag inertia)."""
    volume, com, inertia_unit, _aabb, _n = stl_mass_properties(path)
    density = mass / volume
    inertia = inertia_unit * density
    evals, evecs = np.linalg.eigh(inertia)
    idx = np.argsort(evals)[::-1]
    evals, evecs = evals[idx], evecs[:, idx]
    if np.linalg.det(evecs) < 0:
        evecs[:, 2] *= -1
    # rotation matrix -> quaternion [w,x,y,z]
    t = np.trace(evecs)
    if t > 0:
        r = np.sqrt(1 + t)
        q = np.array([0.5 * r,
                      (evecs[2, 1] - evecs[1, 2]) / (2 * r),
                      (evecs[0, 2] - evecs[2, 0]) / (2 * r),
                      (evecs[1, 0] - evecs[0, 1]) / (2 * r)])
    else:
        i = int(np.argmax(np.diag(evecs)))
        j, k = (i + 1) % 3, (i + 2) % 3
        r = np.sqrt(1 + evecs[i, i] - evecs[j, j] - evecs[k, k])
        q = np.zeros(4)
        q[i + 1] = 0.5 * r
        q[0] = (evecs[k, j] - evecs[j, k]) / (2 * r)
        q[j + 1] = (evecs[j, i] + evecs[i, j]) / (2 * r)
        q[k + 1] = (evecs[k, i] + evecs[i, k]) / (2 * r)
    q /= np.linalg.norm(q)
    return mass, com, q, evals
