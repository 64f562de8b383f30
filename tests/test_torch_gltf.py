"""The port's glTF import (`vision_tpu_torch/scene/gltf.py`) against the
JAX package's on files written here (`tests/torch_scenes.py`
`GltfBuilder`): `load_gltf` exact on a .gltf with a data URI, a .gltf
with an external .bin, a .glb and an interleaved (byteStride) buffer,
over a node hierarchy of TRS and matrix nodes, whole or one node's one
primitive; `load_gltf_scene` dict-equal on `tests/test_importers.py`'s
triangle and on `gltf_cbox`; C16 (normalized integer uvs); `Scene(".glb")`
against the JAX scene; and `gltf_cbox` rendered by both packages."""
import math
import os

import numpy as np
import pytest
import torch

import vision_tpu_torch as vt
from tests.test_importers import _tri_gltf
from tests.test_torch_scene import _assert_same_scene
from tests.torch_parity import assert_wave_close, jax_scene_arrays, jax_wave
from tests.torch_scenes import GltfBuilder, gltf_cbox, gltf_cbox_scene
from vision_tpu.scene import gltf as jgltf
from vision_tpu.scene.scene import Scene as JScene
from vision_tpu_torch.scene import gltf as tgltf
from vision_tpu_torch.scene import shapes as tshapes

torch.set_num_threads(2)


def _same_mesh(a, b):
    for k in ("positions", "normals", "uvs", "triangles"):
        x, y = getattr(a, k), getattr(b, k)
        assert x.shape == y.shape and x.dtype == y.dtype, k
        np.testing.assert_array_equal(x, y, err_msg=k)


def _prim(g, mesh, index_type="uint32", normals=True, uvs=True,
          interleaved=False):
    """A primitive dict over `mesh`'s arrays in `g`'s buffer."""
    cols = [mesh.positions] + ([mesh.normals] if normals else []) + (
        [mesh.uvs] if uvs else [])
    if interleaved:
        accs = g.interleaved([np.asarray(c, np.float32) for c in cols])
    else:
        accs = [g.accessor(np.asarray(c, np.float32)) for c in cols]
    names = ["POSITION"] + (["NORMAL"] if normals else []) + (
        ["TEXCOORD_0"] if uvs else [])
    prim = {"attributes": dict(zip(names, accs))}
    if index_type is not None:
        prim["indices"] = g.accessor(
            np.asarray(mesh.triangles).reshape(-1).astype(index_type))
    return prim


def _quat(axis, angle):
    axis = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    s = math.sin(angle / 2)
    return [float(axis[0] * s), float(axis[1] * s), float(axis[2] * s),
            math.cos(angle / 2)]


def _write(path, kind, interleaved=False):
    """Three meshes under a node hierarchy: a TRS root (non-uniform scale,
    a rotation) holding a sphere, its child a matrix node holding a cube
    of two primitives (uint16 indices without uvs; no indices, no
    normals), its grandchild a TRS node holding the sphere again, a
    second root holding a quad, and a node with no mesh."""
    g = GltfBuilder()
    sphere, cube, quad = (tshapes.make_sphere(0.5, 6), tshapes.make_cube(0.7),
                          tshapes.make_quad(2.0, 1.0))
    g.doc["meshes"].append({"primitives": [_prim(g, sphere,
                                                 interleaved=interleaved)]})
    soup = tshapes.TriMesh(cube.positions[cube.triangles.reshape(-1)],
                           cube.normals, cube.uvs, cube.triangles)
    g.doc["meshes"].append({"primitives": [
        _prim(g, cube, "uint16", uvs=False, interleaved=interleaved),
        _prim(g, soup, None, normals=False, uvs=False)]})
    g.doc["meshes"].append({"primitives": [_prim(g, quad, "uint8")]})
    root = g.node(mesh=0, translation=[0.5, -1.0, 2.0], scale=[1.0, 2.0, 0.5],
                  rotation=_quat([1, 2, 3], 0.7))
    m = np.eye(4)
    m[:3, :3] = [[0, -1.5, 0], [1.5, 0, 0], [0, 0, 1.5]]
    m[:3, 3] = [0.1, 0.2, 0.3]
    child = g.node(parent=root, mesh=1, matrix=m.T.reshape(-1).tolist())
    g.node(parent=child, mesh=0, translation=[3.0, 0.0, 0.0],
           rotation=_quat([0, 1, 0], -1.1), scale=[0.5, 0.5, 0.5])
    g.node(mesh=2, rotation=_quat([1, 0, 0], math.pi / 2))
    g.node(name="empty", translation=[1.0, 1.0, 1.0])
    return g.save(str(path), kind)


KINDS = {"glb": ("m.glb", "glb", False), "bin": ("m.gltf", "bin", False),
         "data": ("m.gltf", "data", False),
         "interleaved": ("m.glb", "glb", True)}
SELECT = {"all": (None, None), "node1": (1, None), "node1_prim1": (1, 1),
          "node2": (2, None), "prim0": (None, 0)}


@pytest.mark.parametrize("select", sorted(SELECT))
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_load_gltf_matches_jax(tmp_path, kind, select):
    fn, how, inter = KINDS[kind]
    path = _write(tmp_path / fn, how, inter)
    node, prim = SELECT[select]
    _same_mesh(tgltf.load_gltf(path, node, prim),
               jgltf.load_gltf(path, node, prim))


def test_load_gltf_scene_dict_equal(tmp_path):
    """The importer's scene dict, key for key and value for value, on the
    triangle of tests/test_importers.py and on gltf_cbox."""
    for path in (_tri_gltf(str(tmp_path)), gltf_cbox(str(tmp_path))):
        a, b = tgltf.load_gltf_scene(path), jgltf.load_gltf_scene(path)
        assert a == b
        assert repr(a) == repr(b)


@pytest.mark.parametrize("dtype", ["uint8", "uint16"])
def test_normalized_uvs_c16(tmp_path, dtype):
    """C16: TEXCOORD_0 stored as normalized UNSIGNED_BYTE / SHORT. The JAX
    importer ignores `normalized` and takes the raw integers (0..255 or
    0..65535); the port divides by the type's maximum (the glTF 2.0
    rule). Positions, normals and triangles agree."""
    g = GltfBuilder()
    mesh = tshapes.make_sphere(1.0, 8)
    g.node(mesh=g.mesh(mesh, uv_normalized=dtype))
    path = g.save(str(tmp_path / "n.glb"))
    a, b = tgltf.load_gltf(path), jgltf.load_gltf(path)
    top = np.iinfo(dtype).max
    q = np.round(np.clip(mesh.uvs, 0, 1) * top)
    np.testing.assert_array_equal(b.uvs, q.astype(np.float32))
    np.testing.assert_array_equal(
        a.uvs, (q.astype(np.float32) / np.float32(top)).astype(np.float32))
    assert np.abs(a.uvs - mesh.uvs).max() <= 0.5 / top + 1e-7
    for k in ("positions", "normals", "triangles"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))


@pytest.fixture(scope="module")
def cbox_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("gltf_cbox"))
    gltf_cbox(d)
    return d


def test_scene_from_glb_matches_jax(cbox_dir):
    """`Scene("gltf_cbox.glb")`: every SceneData array (the JPEG floor in
    the atlas through the port's decoder, the emissive light, the point
    light), the imported camera and the filter equal to the JAX scene's;
    996 triangles take the dense sweep."""
    path = os.path.join(cbox_dir, "gltf_cbox.glb")
    ps = vt.load_scene(path, device="cpu")
    js = JScene(path)
    assert ps.data.pbvh is None and ps.data.tri_geom.shape[0] == 996
    assert ps.resolution == (512, 512) and ps.max_depth == 16
    assert ps.data.lights.n_lights == 2 and ps.data.atlas.n_real == 1
    _assert_same_scene(ps.data, ps.camera, ps.filter, jax_scene_arrays(js))


def test_gltf_cbox_render_matches_jax(cbox_dir):
    """gltf_cbox at 32^2, depth 8, 4 spp: the regeneration wavefront of
    both packages from the same seeds, at the tolerances of
    tests/test_torch_render.py (8x8 block error and bias <= 0.01, equal
    sample counts, ray counts within 1%)."""
    desc, d = gltf_cbox_scene(cbox_dir, 32)
    ps = vt.Scene(desc, "cpu", scene_dir=d)
    js = JScene(desc, scene_dir=d)
    assert ps.max_depth == 8
    assert_wave_close(ps, jax_wave(js, 4), 4)
