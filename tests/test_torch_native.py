"""The port's native STL mass-properties library (``native/``) against its
numpy twin and the JAX package's numpy version, on a synthetic binary-STL
box: volume, CoM, inertia and AABB agree to 1e-12.  The C library builds
into ``build/native/`` and never falls back: a failed build raises."""
import shutil
import struct

import numpy as np
import pytest

from mujoco_playground_tpu import native as jax_native
from mujoco_playground_tpu_torch import native

TOL = 1e-12


def _make_box_stl(path, half=(0.1, 0.2, 0.3)):
    """Write a binary STL of an axis-aligned box (12 triangles)."""
    hx, hy, hz = half
    v = np.array([[sx * hx, sy * hy, sz * hz]
                  for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)])
    # 12 triangles with outward winding
    faces = [
        (0, 2, 1), (1, 2, 3),
        (4, 5, 6), (5, 7, 6),
        (0, 1, 4), (1, 5, 4),
        (2, 6, 3), (3, 6, 7),
        (0, 4, 2), (2, 4, 6),
        (1, 3, 5), (3, 7, 5),
    ]
    with open(path, "wb") as f:
        f.write(b"\0" * 80)
        f.write(struct.pack("<I", len(faces)))
        for (a, b, c) in faces:
            f.write(struct.pack("<3f", 0, 0, 0))
            for idx in (a, b, c):
                f.write(struct.pack("<3f", *v[idx]))
            f.write(struct.pack("<H", 0))


def _assert_same(got, want):
    for g, w, name in zip(got[:4], want[:4],
                          ("volume", "com", "inertia", "aabb")):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL, err_msg=name)
    assert got[4] == want[4]


@pytest.mark.parametrize("half", [(0.1, 0.2, 0.3), (0.5, 0.05, 0.25)])
def test_native_and_numpy_twin_match_jax(tmp_path, half):
    path = str(tmp_path / "box.stl")
    _make_box_stl(path, half)
    want = jax_native._stl_mass_properties_numpy(path)
    c_out = native.stl_mass_properties(path)
    _assert_same(c_out, want)
    _assert_same(native.stl_mass_properties_numpy(path), want)
    assert c_out[4] == 12
    hx, hy, hz = half
    np.testing.assert_allclose(abs(c_out[0]), 8 * hx * hy * hz, rtol=1e-6)
    assert native.library_path().parent == native.BUILD_DIR
    assert native.library_path().exists()


def test_mesh_inertial_matches_jax(tmp_path):
    path = str(tmp_path / "box.stl")
    _make_box_stl(path)
    got = native.mesh_inertial(path, 2.5)
    want = jax_native.mesh_inertial(path, 2.5)
    assert got[0] == want[0]
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)


def test_failed_build_raises(tmp_path, monkeypatch):
    """A compiler that fails makes the call raise with its output; nothing
    falls back to numpy."""
    path = str(tmp_path / "box.stl")
    _make_box_stl(path)
    monkeypatch.setenv("CC", shutil.which("false"))
    with pytest.raises(RuntimeError, match=r"failed \(exit 1\)"):
        native.stl_mass_properties(path)
    assert not native.library_path().exists()
    monkeypatch.setenv("CC", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="failed"):
        native.mesh_inertial(path, 1.0)


def test_unreadable_file_raises(tmp_path):
    with pytest.raises(RuntimeError, match="error -10"):
        native.stl_mass_properties(str(tmp_path / "missing.stl"))
