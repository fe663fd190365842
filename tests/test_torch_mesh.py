"""The port's ``spec/mesh.py`` against the JAX package's and against MuJoCo
3.10's compiler, on three synthetic binary STLs written to ``tmp_path``: a
box, a non-convex notched prism and two disjoint boxes.

* ``mesh_mass_properties`` in all four modes (legacy, exact, convex,
  shell) against JAX's: 1e-12; against MuJoCo's compile of ``<mesh
  file=... inertia=mode>`` (``mass=5``, and the mass its density gives):
  mass, CoM and inertia 1e-8, as tests/test_mjcf_import.py holds the JAX
  module.  MuJoCo gives the inertia as principal moments and a principal
  frame; the moments are held at 1e-8, and the tensor in MuJoCo's frame
  by its diagonal at 1e-8.  Its off-diagonal is not held: on the two
  boxes in the exact and shell modes MuJoCo's frame sits ~9e-5 rad from
  the exact principal axes, so that its reconstructed tensor is 1.4e-7
  from the analytic one where the port's is 3e-17 from it (the analytic
  tensors of the box and of the two boxes are held at 1e-12 instead).
* ``load_stl``, ``principal_frame``, ``mat_to_quat`` and ``convex_hull``
  against JAX's: bitwise.
"""
import numpy as np
import pytest

from _torch_stl import box_mesh, prism_mesh, rotation, tensor, write_stl
from mujoco_playground_tpu.spec import mesh as jax_mesh
from mujoco_playground_tpu_torch.spec import mesh

mujoco = pytest.importorskip("mujoco")

MODES = ("legacy", "exact", "convex", "shell")
JAX_TOL = 1e-12
MUJOCO_TOL = 1e-8


def box_tensor(boxes, mass):
    """(CoM, inertia about it) of solid boxes [(lo, hi), ...] of one
    density and total ``mass``, in closed form (float32 corners, as the
    STL stores them)."""
    lo, hi = (np.array([np.float32(b[k]) for b in boxes], np.float64)
              for k in (0, 1))
    size = hi - lo
    vol = size.prod(1)
    m = mass * vol / vol.sum()
    c = (lo + hi) / 2
    com = (m[:, None] * c).sum(0) / mass
    inertia = np.zeros((3, 3))
    for mi, s, ci in zip(m, size, c):
        d = ci - com
        inertia += (mi / 12 * np.diag([s[1] ** 2 + s[2] ** 2,
                                       s[0] ** 2 + s[2] ** 2,
                                       s[0] ** 2 + s[1] ** 2])
                    + mi * ((d @ d) * np.eye(3) - np.outer(d, d)))
    return com, inertia


BOXES = {"box": [((-0.1, -0.2, -0.05), (0.3, 0.25, 0.15))],
         "two_boxes": [((0.0, 0.0, 0.0), (0.1, 0.1, 0.1)),
                       ((0.3, 0.05, 0.0), (0.5, 0.15, 0.05))]}


def meshes():
    box = box_mesh(*BOXES["box"][0])
    # a rectangle with a V notch cut into its top edge
    notched = prism_mesh([(0.0, 0.0), (0.4, 0.0), (0.4, 0.3), (0.25, 0.3),
                          (0.2, 0.1), (0.15, 0.3), (0.0, 0.3)],
                         (0.2, 0.05), 0.125)
    (a_v, a_f), (b_v, b_f) = (box_mesh(*b) for b in BOXES["two_boxes"])
    two = (np.concatenate([a_v, b_v]),
           a_f + [tuple(i + len(a_v) for i in f) for f in b_f])
    return {"box": box, "notched": notched, "two_boxes": two}


@pytest.fixture(scope="module")
def stl_paths(tmp_path_factory):
    out = tmp_path_factory.mktemp("meshes")
    paths = {}
    for name, (v, f) in meshes().items():
        tri = v[np.array(f)]
        assert np.einsum("ij,ij->i", tri[:, 0], np.cross(
            tri[:, 1], tri[:, 2])).sum() > 0       # closed and outward
        paths[name] = str(out / f"{name}.stl")
        write_stl(paths[name], v, f)
    return paths


@pytest.mark.parametrize("name", ["box", "notched", "two_boxes"])
@pytest.mark.parametrize("mode", MODES)
def test_mass_properties_match_jax_and_mujoco(stl_paths, name, mode):
    path = stl_paths[name]
    tris = mesh.load_stl(path)
    np.testing.assert_array_equal(tris, jax_mesh.load_stl(path))
    m, com, inertia = mesh.mesh_mass_properties(tris, mass=5.0, mode=mode)
    jm, jcom, jinertia = jax_mesh.mesh_mass_properties(tris, mass=5.0,
                                                       mode=mode)
    assert m == jm == 5.0
    np.testing.assert_allclose(com, jcom, rtol=0, atol=JAX_TOL)
    np.testing.assert_allclose(inertia, jinertia, rtol=0, atol=JAX_TOL)
    # density semantics: the mesh's own mass at 1000 kg/m^3
    md, _, _ = mesh.mesh_mass_properties(tris, mode=mode)
    assert md == pytest.approx(
        jax_mesh.mesh_mass_properties(tris, mode=mode)[0], abs=JAX_TOL)
    xml = f"""<mujoco>
      <asset><mesh name="m" file="{path}" inertia="{mode}"/></asset>
      <worldbody><body name="b"><freejoint/>
        <geom type="mesh" mesh="m" mass="5"/>
      </body></worldbody></mujoco>"""
    mj = mujoco.MjModel.from_xml_string(xml)
    mj_density = mujoco.MjModel.from_xml_string(xml.replace(' mass="5"', ""))
    assert md == pytest.approx(mj_density.body_mass[1], rel=MUJOCO_TOL)
    np.testing.assert_allclose(com, mj.body_ipos[1], rtol=0,
                               atol=MUJOCO_TOL)
    np.testing.assert_allclose(np.sort(np.linalg.eigvalsh(inertia)),
                               np.sort(mj.body_inertia[1]), rtol=0,
                               atol=MUJOCO_TOL)
    frame = rotation(mj.body_iquat[1])
    np.testing.assert_allclose(np.diag(frame.T @ inertia @ frame),
                               mj.body_inertia[1], rtol=0, atol=MUJOCO_TOL)
    diag, quat = mesh.principal_frame(inertia)
    jdiag, jquat = jax_mesh.principal_frame(inertia)
    np.testing.assert_array_equal(diag, jdiag)
    np.testing.assert_array_equal(quat, jquat)
    np.testing.assert_allclose(tensor(quat, diag), inertia, atol=1e-12)


@pytest.mark.parametrize("name", ["box", "two_boxes"])
def test_exact_inertia_matches_closed_form(stl_paths, name):
    """Solid boxes in the exact mode (and a single box in every volume
    mode) against the closed form: 1e-12."""
    tris = mesh.load_stl(stl_paths[name])
    com, inertia = box_tensor(BOXES[name], 5.0)
    for mode in ("exact",) + (("legacy", "convex") if name == "box" else ()):
        _, got_com, got = mesh.mesh_mass_properties(tris, mass=5.0,
                                                    mode=mode)
        np.testing.assert_allclose(got_com, com, rtol=0, atol=1e-12)
        np.testing.assert_allclose(got, inertia, rtol=0, atol=1e-12)


@pytest.mark.parametrize("name", ["box", "notched", "two_boxes"])
def test_convex_hull_matches_jax(stl_paths, name):
    verts = mesh.load_stl(stl_paths[name]).reshape(-1, 3)
    hv, faces = mesh.convex_hull(verts)
    jhv, jfaces = jax_mesh.convex_hull(verts)
    np.testing.assert_array_equal(hv, jhv)
    np.testing.assert_array_equal(faces, jfaces)
    # outward: every hull vertex lies on or behind every face's plane
    tri = hv[faces]
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    assert float(np.einsum("fk,vfk->vf", n, hv[:, None] - tri[None, :, 0]
                           ).max()) < 1e-12


def test_mat_to_quat_matches_jax():
    rng = np.random.default_rng(0)
    for _ in range(20):
        q = rng.normal(size=4)
        R = tensor(q / np.linalg.norm(q), np.ones(3))  # identity check
        np.testing.assert_allclose(R, np.eye(3), atol=1e-12)
        A = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        A *= np.sign(np.linalg.det(A))
        np.testing.assert_array_equal(mesh.mat_to_quat(A),
                                      jax_mesh.mat_to_quat(A))


def test_ascii_stl_and_bad_files(tmp_path):
    v, f = box_mesh((0, 0, 0), (1, 2, 3))
    lines = ["solid box"]
    for tri in f:
        lines += ["facet normal 0 0 0", "outer loop"]
        lines += [f"vertex {x} {y} {z}" for x, y, z in v[list(tri)]]
        lines += ["endloop", "endfacet"]
    ascii_path = tmp_path / "box_ascii.stl"
    ascii_path.write_text("\n".join(lines + ["endsolid box"]))
    np.testing.assert_array_equal(mesh.load_stl(str(ascii_path)),
                                  jax_mesh.load_stl(str(ascii_path)))
    bad = tmp_path / "bad.stl"
    bad.write_bytes(b"nothing here")
    with pytest.raises(ValueError, match="not a valid STL"):
        mesh.load_stl(str(bad))
    with pytest.raises(ValueError, match="unknown mesh inertia mode"):
        mesh.mesh_mass_properties(v[np.array(f)], mode="volume")
