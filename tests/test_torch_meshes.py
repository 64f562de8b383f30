"""The port's mesh files (`vision_tpu_torch/scene/shapes.py`, `native.py`,
`csrc/mesh_io.cpp`) against the JAX package's on files written here from
a numpy seed: OBJ through both parsers (the Python `load_obj` and the
native one behind `load_model`), PLY (ascii and binary_little_endian),
STL (binary and ascii), each exact; the faults the port does not copy
(C3: the STL weld's clamp; C15: the native parser's vertex key; C17: a
binary PLY face's scalar property), each shown; and `model` shapes in
scenes: the same SceneData as the JAX package's, the cbox_sphere twins
written as OBJ / PLY / GLB / STL against the procedural sphere, a missing
file skipped, and one OBJ placed 16 times through the TLAS (K3's plain
walk)."""
import numpy as np
import pytest
import torch

import vision_tpu_torch as vt
from tests.test_torch_scene import _assert_same_scene
from tests.torch_parity import jax_scene_arrays, np_
from tests.torch_scenes import (MESH_FORMATS, cbox_sphere, cbox_sphere_files,
                                cbox_spheres_instanced,
                                cbox_spheres_instanced_obj, write_stl)
from vision_tpu import native as jnative
from vision_tpu.scene import shapes as jshapes
from vision_tpu.scene.scene import Scene as JScene
from vision_tpu_torch import native as tnative
from vision_tpu_torch.integrator import pt as tpt
from vision_tpu_torch.scene import shapes as tshapes

torch.set_num_threads(2)


def _same_mesh(a, b):
    for k in ("positions", "normals", "uvs", "triangles"):
        x, y = getattr(a, k), getattr(b, k)
        assert x.shape == y.shape and x.dtype == y.dtype, k
        np.testing.assert_array_equal(x, y, err_msg=k)


def _rand_mesh(seed, n=40):
    g = np.random.default_rng(seed)
    return (g.normal(size=(n, 3)) * 3).astype(np.float32), g


def _obj_text(kind, seed):
    """An OBJ of random vertices and a mix of triangles, quads and
    pentagons (fan-triangulated by both parsers)."""
    P, g = _rand_mesh(seed)
    n = len(P)
    VT = g.random((n + 5, 2)).astype(np.float32)
    VN = g.normal(size=(n + 3, 3)).astype(np.float32)
    lines = [f"v {x:.9g} {y:.9g} {z:.9g}" for x, y, z in P]
    if kind in ("full", "v_vt", "negative", "no_normals"):
        lines += [f"vt {u:.9g} {v:.9g}" for u, v in VT]
    if kind in ("full", "v_vn", "negative"):
        lines += [f"vn {x:.9g} {y:.9g} {z:.9g}" for x, y, z in VN]
    for f in range(60):
        k = (3, 3, 4, 5)[f % 4]
        vi = g.choice(n, k, replace=False)
        ti = g.integers(0, len(VT), k)
        ni = g.integers(0, len(VN), k)
        if kind == "negative":
            toks = [f"{v - n}/{t - len(VT)}/{m - len(VN)}"
                    for v, t, m in zip(vi, ti, ni)]
        elif kind == "full":
            toks = [f"{v + 1}/{t + 1}/{m + 1}" for v, t, m in zip(vi, ti, ni)]
        elif kind == "v_vt" or kind == "no_normals":
            toks = [f"{v + 1}/{t + 1}" for v, t in zip(vi, ti)]
        elif kind == "v_vn":
            toks = [f"{v + 1}//{m + 1}" for v, m in zip(vi, ni)]
        else:
            toks = [f"{v + 1}" for v in vi]
        # a face repeats earlier vertices, so both caches are exercised
        lines.append("f " + " ".join(toks))
    return "# test\n" + "\n".join(lines) + "\n"


OBJ_KINDS = ("full", "plain", "v_vt", "v_vn", "negative", "no_normals")


@pytest.mark.parametrize("smooth", [True, False])
@pytest.mark.parametrize("kind", OBJ_KINDS)
def test_load_obj_matches_jax(tmp_path, kind, smooth):
    """The Python parser: one vertex per distinct face token; normals
    area-weighted when the file has none and `smooth`."""
    p = tmp_path / "m.obj"
    p.write_text(_obj_text(kind, OBJ_KINDS.index(kind)))
    _same_mesh(tshapes.load_obj(str(p), smooth=smooth),
               jshapes.load_obj(str(p), smooth=smooth))


@pytest.mark.parametrize("smooth", [True, False])
@pytest.mark.parametrize("kind", OBJ_KINDS)
def test_load_model_obj_matches_jax(tmp_path, kind, smooth):
    """The native route on both sides (one vertex per distinct index
    triple; area-weighted normals without vn, whatever `smooth` says)."""
    assert jnative.available()
    p = tmp_path / "m.obj"
    p.write_text(_obj_text(kind, 10 + OBJ_KINDS.index(kind)))
    _same_mesh(tshapes.load_model(str(p), smooth=smooth),
               jshapes.load_model(str(p), smooth=smooth))


def test_obj_native_missing_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        tnative.load_obj_native(str(tmp_path / "none.obj"))


def _jax_obj_key(vi, ti, ni):
    """`native/mesh_io.cpp:129-130`'s vertex key of a 0-based triple, in
    its uint64 arithmetic (the shared library exports no key function)."""
    m = (1 << 64) - 1
    return ((((vi + 1) << 42) & m) ^ (((ti + 2) << 21) & m) ^ (ni + 2)) & m


@pytest.mark.parametrize("a,b", [
    ((2 ** 22 + 7, 3, 5), (7, 3, 5)),  # past 2^22 positions vi wraps
    ((1, 2 ** 21, 4), (2, 0, 4)),      # past 2^21 - 2 uvs ti spills into vi
])
def test_obj_key_c15(a, b):
    """C15: two different index triples share the JAX native parser's key,
    so the later vertex would take the earlier one's index; the port's
    key (`vt_obj_key`, called through ctypes) holds the triple whole."""
    assert _jax_obj_key(*a) == _jax_obj_key(*b)
    assert tnative.obj_key(*a) != tnative.obj_key(*b)
    for t in (a, b):
        assert tnative.obj_key(*t) == (t[0], (t[1] + 1) << 32 | (t[2] + 1))


# ---- PLY ----

def _ply_bytes(fmt, P, N=None, UV=None, uv_names=("s", "t"), faces=(),
               face_extra=False):
    """A PLY of float vertex columns and `list uchar int vertex_indices`
    faces (with a trailing `uchar flags` property when `face_extra`)."""
    cols, names = [P], ["x", "y", "z"]
    if N is not None:
        cols.append(N)
        names += ["nx", "ny", "nz"]
    if UV is not None:
        cols.append(UV)
        names += list(uv_names)
    V = np.concatenate(cols, 1).astype(np.float32)
    head = [f"ply", f"format {fmt} 1.0", "comment test",
            f"element vertex {len(V)}"]
    head += [f"property float {n}" for n in names]
    head += [f"element face {len(faces)}",
             "property list uchar int vertex_indices"]
    if face_extra:
        head.append("property uchar flags")
    head.append("end_header")
    out = ("\n".join(head) + "\n").encode()
    if fmt == "ascii":
        rows = [" ".join(f"{v:.9g}" for v in r) for r in V]
        rows += [" ".join(map(str, [len(f)] + list(f)
                              + ([7] if face_extra else []))) for f in faces]
        return out + ("\n".join(rows) + "\n").encode()
    out += V.astype("<f4").tobytes()
    for f in faces:
        out += bytes([len(f)]) + np.asarray(f, "<i4").tobytes()
        if face_extra:
            out += bytes([7])
    return out


def _faces(g, n, sizes):
    return [list(g.choice(n, k, replace=False)) for k in sizes]


@pytest.mark.parametrize("fmt", ["ascii", "binary_little_endian"])
@pytest.mark.parametrize("attrs", ["none", "normals", "st", "uv", "all"])
@pytest.mark.parametrize("sizes", ["tris", "quads", "mixed"])
def test_load_ply_matches_jax(tmp_path, fmt, attrs, sizes):
    P, g = _rand_mesh(3)
    N = g.normal(size=P.shape) if attrs in ("normals", "all") else None
    UV = g.random((len(P), 2)) if attrs in ("st", "uv", "all") else None
    k = {"tris": [3] * 30, "quads": [4] * 30, "mixed": [3, 4, 5] * 10}[sizes]
    p = tmp_path / "m.ply"
    p.write_bytes(_ply_bytes(fmt, P, N, UV, ("u", "v") if attrs == "uv"
                             else ("s", "t"), _faces(g, len(P), k)))
    _same_mesh(tshapes.load_ply(str(p)), jshapes.load_ply(str(p)))


@pytest.mark.parametrize("sizes", ["tris", "mixed"])
def test_ply_face_property_c17(tmp_path, sizes):
    """C17: a binary PLY whose face element has a scalar property beside
    its list. The JAX package reads only the list, so it takes the
    property's byte for the next face's count and misreads the faces
    (here it raises or returns other triangles); the port reads every
    property in the header's order and gives the mesh of the same file
    written as ascii."""
    P, g = _rand_mesh(4)
    faces = _faces(g, len(P), {"tris": [3] * 20, "mixed": [3, 4] * 10}[sizes])
    a, b = tmp_path / "a.ply", tmp_path / "b.ply"
    a.write_bytes(_ply_bytes("ascii", P, faces=faces, face_extra=True))
    b.write_bytes(_ply_bytes("binary_little_endian", P, faces=faces,
                             face_extra=True))
    want = jshapes.load_ply(str(a))
    _same_mesh(tshapes.load_ply(str(a)), want)
    _same_mesh(tshapes.load_ply(str(b)), want)
    try:
        got = jshapes.load_ply(str(b))
    except Exception:
        return
    assert not np.array_equal(got.triangles, want.triangles)


# ---- STL ----

def _stl_ascii(path, mesh):
    tri = mesh.positions[mesh.triangles]
    lines = ["solid test"]
    for t in tri:
        lines += ["facet normal 0 0 0", "outer loop"]
        lines += ["vertex %.9g %.9g %.9g" % tuple(v) for v in t]
        lines += ["endloop", "endfacet"]
    lines.append("endsolid test")
    path.write_text("\n".join(lines) + "\n")


@pytest.mark.parametrize("kind", ["binary", "ascii"])
@pytest.mark.parametrize("sign", ["positive", "negative"])
def test_load_stl(tmp_path, kind, sign):
    """Positive coordinates: exact against the JAX package. Negative ones:
    the JAX weld (np.maximum.at into zeros) clamps them to 0 (C3); the
    port keeps each weld cell's first vertex, so its mesh has the file's
    positions."""
    mesh = tshapes.make_sphere(0.4, 6)
    off = np.float32(1.0 if sign == "positive" else -0.2)
    mesh = tshapes.TriMesh(mesh.positions + off, mesh.normals, mesh.uvs,
                           mesh.triangles)
    p = tmp_path / "m.stl"
    if kind == "binary":
        write_stl(str(p), mesh)
    else:
        _stl_ascii(p, mesh)
    got, ref = tshapes.load_stl(str(p)), jshapes.load_stl(str(p))
    np.testing.assert_array_equal(
        got.positions[got.triangles], mesh.positions[mesh.triangles])
    if sign == "positive":
        _same_mesh(got, ref)
    else:
        assert (mesh.positions < 0).any()
        assert (ref.positions >= 0).all()
        assert not np.array_equal(ref.positions[ref.triangles],
                                  mesh.positions[mesh.triangles])


# ---- scenes with `model` shapes ----

@pytest.fixture(scope="module")
def sphere_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("meshes")
    return cbox_sphere_files(str(d), 16, sub_div=16)


@pytest.mark.parametrize("fmt", MESH_FORMATS)
def test_model_scene_matches_jax(sphere_files, fmt):
    """A `model` shape of each format: every SceneData array, the camera
    and the filter equal to the JAX package's scene. The STL sphere, centred
    on its origin, is the exception C3 makes: the JAX weld moves its
    negative coordinates to 0, so its sphere's rows differ and the rest of
    the scene does not."""
    s = sphere_files[fmt]
    ps = vt.load_scene(s, device="cpu")
    js = JScene(s)
    ref = jax_scene_arrays(js)
    if fmt == "stl":
        a, b = np_(ps.data.tri_pack), ref["tri_pack"]
        np.testing.assert_array_equal(a[:36], b[:36])  # the cbox
        assert (a[36:, :9] != b[36:, :9]).any(-1).mean() > 0.5
        ref["tri_pack"] = a
        ref["tri_p0"], ref["tri_e1"], ref["tri_e2"] = a[:, :3], a[:, 3:6], a[:, 6:9]
        ref["world_radius"] = np.float32(ps.data.world_radius)
    _assert_same_scene(ps.data, ps.camera, ps.filter, ref)


@pytest.mark.parametrize("fmt", MESH_FORMATS)
def test_file_twin_matches_procedural(sphere_files, fmt):
    """The sphere written as OBJ, PLY or GLB gives the procedural scene's
    tri_pack bit for bit; as STL, which has no normals or uvs, the same
    triangles at the same positions."""
    ps = vt.load_scene(sphere_files[fmt], device="cpu")
    proc = vt.load_scene(cbox_sphere(16, sub_div=16), device="cpu")
    a, b = np_(ps.data.tri_pack), np_(proc.data.tri_pack)
    assert a.shape == b.shape == (36 + 960, 32)
    if fmt == "stl":
        np.testing.assert_array_equal(a[:, :9], b[:, :9])
        np.testing.assert_array_equal(a[:, 24:], b[:, 24:])
    else:
        np.testing.assert_array_equal(a, b)


def test_obj_twin_renders_as_procedural(sphere_files):
    """The OBJ twin of cbox_sphere(sub_div=16) (996 triangles: K1's plain
    sweep) renders the procedural scene's image bit for bit."""
    imgs = []
    for s in (sphere_files["obj"], cbox_sphere(16, sub_div=16)):
        sc = vt.load_scene(s, device="cpu")
        assert sc.data.pbvh is None and sc.data.ipbvh is None
        img, _ = tpt.render_wave(sc.data, sc.camera, sc.filter, 0, 4,
                                 sc.max_depth)
        imgs.append(np_(img))
    assert imgs[0].mean() > 0.01
    np.testing.assert_array_equal(imgs[0], imgs[1])


@pytest.mark.parametrize("fn", ["gone.obj", "gone.ply", "gone.glb", "x.fbx"])
def test_missing_mesh_file_skips(fn):
    """A mesh file that cannot be read (missing, or a format neither
    package reads) skips its shape with a warning in both packages."""
    s = cbox_sphere(16, sub_div=8)
    s["shapes"].insert(3, {"type": "model", "name": "gone",
                           "param": {"fn": fn, "material": "White"}})
    with pytest.warns(UserWarning, match="skipping shape 'gone'"):
        ps = vt.load_scene(s, device="cpu")
    with pytest.warns(UserWarning, match="skipping shape 'gone'"):
        js = JScene(s)
    _assert_same_scene(ps.data, ps.camera, ps.filter, jax_scene_arrays(js))


def test_instanced_obj_takes_k3(tmp_path, monkeypatch):
    """One OBJ placed 16 times: the registry parses it once (its key is
    the file's absolute path), the scene instances it as the JAX package
    does (TLAS over 17 instances), and K3's plain walk renders the
    procedural instanced scene's image bit for bit."""
    calls = []
    load = tshapes.load_model
    monkeypatch.setattr(tshapes, "load_model",
                        lambda *a, **k: calls.append(a) or load(*a, **k))
    s = cbox_spheres_instanced_obj(str(tmp_path), 16, sub_div=8)
    ps = vt.load_scene(s, device="cpu")
    assert len(calls) == 1
    proc = vt.load_scene(cbox_spheres_instanced(16, sub_div=8), device="cpu")
    assert ps.data.ipbvh is not None and ps.data.ipbvh.n_inst == 17
    js = JScene(s)
    assert js.data.ipbvh is not None
    np.testing.assert_array_equal(np_(ps.data.tri_pack),
                                  np.asarray(js.data.tri_pack))
    np.testing.assert_array_equal(np_(ps.data.tri_pack),
                                  np_(proc.data.tri_pack))
    imgs = []
    for sc in (ps, proc):
        img, _ = tpt.render_wave(sc.data, sc.camera, sc.filter, 0, 2, 3)
        imgs.append(np_(img))
    assert imgs[0].mean() > 0.01
    np.testing.assert_array_equal(imgs[0], imgs[1])
