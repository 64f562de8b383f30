"""The port's scene loader against the JAX package's: the same scene JSON
gives the same packed geometry, id tables, material and light tables,
camera and filter; `scene_from_arrays` carries a JAX scene across; and a
scene outside the ported slice raises NotImplementedError."""
import copy
import dataclasses
import warnings

import numpy as np
import pytest
import torch

import vision_tpu_torch as vt
from tests.fixtures import make_glass_cbox
from tests.torch_parity import cbox, jax_scene_arrays, np_
from vision_tpu.scene.scene import Scene as JScene
from vision_tpu_torch.scene.scene import scene_from_arrays
from vision_tpu_torch.shading.materials import COLUMNS

torch.set_num_threads(2)

LIGHT_FIELDS = ("ltype", "color", "color_tex", "two_sided", "inst_id",
                "total_area", "tri_offset", "tri_count", "a_prob", "a_alias",
                "a_pmf", "tri_base", "sel_prob", "sel_alias", "sel_pmf")


def _standalone_light():
    """The cbox with its emitter as a standalone area light."""
    s = cbox(16)
    quad = s["shapes"].pop()
    s["light_sampler"]["param"]["lights"] = [{
        "type": "area",
        "param": {"color": [17, 12, 4], "scale": 0.5, "two_sided": True,
                  "width": 1, "height": 1,
                  "o2w": quad["param"]["transform"]}}]
    return s


def _two_lights_power():
    """Two emitters selected by power, a sphere and an inline material."""
    s = cbox(16)
    s["light_sampler"]["type"] = "power"
    light = copy.deepcopy(s["shapes"][-1])
    light["param"]["transform"]["param"]["matrix4x4"][3] = [0.5, 1.5, 0, 1]
    light["param"]["emission"]["param"]["scale"] = 2.0
    s["shapes"].append(light)
    s["shapes"].append({"type": "sphere", "name": "ball", "param": {
        "radius": 0.2, "sub_div": 8,
        "material": {"type": "diffuse", "param": {"color": [0.3, 0.5, 0.7]}},
        "transform": {"type": "matrix4x4", "param": {"matrix4x4": [
            [1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0], [0, 0.5, 0.4, 1]]}}}})
    return s


SCENES = {"cbox": lambda: cbox(16), "standalone_light": _standalone_light,
          "two_lights_power": _two_lights_power}


def _assert_same_scene(data, camera, filt, ref):
    """Port records vs the JAX scene's arrays (bit for bit: both are built
    by numpy on the host from the same description)."""
    eq = np.testing.assert_array_equal
    eq(np_(data.tri_geom), np.concatenate(
        [ref["tri_p0"], ref["tri_e1"], ref["tri_e2"]], 1))
    for k in ("tri_pack", "inst_mat", "inst_light"):
        eq(np_(getattr(data, k)), ref[k])
    assert data.world_radius == float(ref["world_radius"])
    assert data.ray_offset == float(ref["ray_offset"])
    for k in COLUMNS:
        eq(np_(getattr(data.materials, k)), ref[f"materials.{k}"])
    assert data.materials.feats == tuple(ref["materials.feats"])
    for k in LIGHT_FIELDS:
        eq(np_(getattr(data.lights, k)), ref[f"lights.{k}"])
    assert data.lights.n_lights == int(ref["lights.n_lights"])
    for k in ("c2w", "tan_half_fov", "lens_radius", "focal_distance"):
        eq(np_(getattr(camera, k)), ref[f"camera.{k}"])
    assert camera.resolution == tuple(ref["camera.resolution"])
    for k in ("radius", "prob", "alias", "pmf", "sign", "int_abs"):
        eq(np_(getattr(filt, k)), ref[f"filter.{k}"])
    assert filt.is_box == bool(ref["filter.is_box"])


@pytest.mark.parametrize("name", sorted(SCENES))
def test_loader_matches_jax(name):
    s = SCENES[name]()
    ps = vt.load_scene(s, device="cpu")
    ref = jax_scene_arrays(JScene(s))
    _assert_same_scene(ps.data, ps.camera, ps.filter, ref)


def test_scene_from_arrays_matches_loader():
    """A JAX scene carried across by scene_from_arrays equals the port's
    own load of CBOX_JSON."""
    s = cbox(32)
    js = JScene(s)
    data, camera, filt = scene_from_arrays(jax_scene_arrays(js), "cpu")
    ps = vt.load_scene(s, device="cpu")
    ref = {"tri_p0": np_(ps.data.tri_geom[:, 0:3]),
           "tri_e1": np_(ps.data.tri_geom[:, 3:6]),
           "tri_e2": np_(ps.data.tri_geom[:, 6:9]),
           "tri_pack": np_(ps.data.tri_pack),
           "inst_mat": np_(ps.data.inst_mat),
           "inst_light": np_(ps.data.inst_light),
           "world_radius": ps.data.world_radius,
           "ray_offset": ps.data.ray_offset,
           "materials.feats": np.asarray(ps.data.materials.feats),
           "lights.n_lights": ps.data.lights.n_lights,
           "camera.resolution": np.asarray(ps.camera.resolution),
           "filter.is_box": ps.filter.is_box}
    ref.update({f"materials.{k}": np_(getattr(ps.data.materials, k))
                for k in COLUMNS})
    ref.update({f"lights.{k}": np_(getattr(ps.data.lights, k))
                for k in LIGHT_FIELDS})
    ref.update({f"camera.{k}": np_(getattr(ps.camera, k))
                for k in ("c2w", "tan_half_fov", "lens_radius",
                          "focal_distance")})
    ref.update({f"filter.{k}": np_(getattr(ps.filter, k))
                for k in ("radius", "prob", "alias", "pmf", "sign", "int_abs")})
    _assert_same_scene(data, camera, filt, ref)
    for k in ("coeffs", "cie_x", "cie_y", "cie_z", "d65n"):
        assert torch.equal(getattr(data.spectrum, k),
                           getattr(ps.data.spectrum, k))
    assert torch.equal(data.atlas.data, ps.data.atlas.data)


def _tensors(obj):
    """Every tensor of a record, its sub-records included."""
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            yield v
        elif dataclasses.is_dataclass(v):
            yield from _tensors(v)


def test_scene_from_arrays_copies_jax_buffers():
    """scene_from_arrays copies every array: no tensor of the port shares
    memory with the JAX scene, no non-writable warning is raised, and after
    the port has rendered from the carried-across arrays the JAX scene's
    arrays are unchanged."""
    from vision_tpu_torch.integrator import pt as tpt
    js = JScene(cbox(16))
    arrays = jax_scene_arrays(js)
    before = {k: np.array(v) for k, v in arrays.items()}
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        data, camera, filt = scene_from_arrays(arrays, "cpu")
    ts = [t for rec in (data, camera, filt) for t in _tensors(rec)]
    assert len(ts) > 40
    for t in ts:
        for v in arrays.values():
            assert not np.may_share_memory(t.numpy(), v)
    img, _ = tpt.render_wave(data, camera, filt, 0, 1, max_depth=2)
    assert float(img.mean()) > 0.0
    after = jax_scene_arrays(js)
    for k, v in before.items():
        np.testing.assert_array_equal(after[k], v)


def test_scene_from_arrays_rejects_out_of_slice():
    with pytest.raises(NotImplementedError, match="slice 1b"):
        scene_from_arrays(jax_scene_arrays(JScene(make_glass_cbox())), "cpu")


def _edit(fn):
    s = cbox(16)
    fn(s)
    return s


def _shape(s, shape):
    s["shapes"].append(shape)


def _sphere(sub_div, x=0.0):
    return {"type": "sphere", "param": {
        "radius": 0.1, "sub_div": sub_div, "material": "White",
        "transform": {"type": "matrix4x4", "param": {"matrix4x4": [
            [1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0], [x, 0.5, 0, 1]]}}}}


OUT_OF_SLICE = {
    "glass_material": (make_glass_cbox, "slice 1b"),
    "oren_nayar": (lambda: _edit(lambda s: s["materials"][0]["param"].update(
        sigma=20.0)), "slice 1b"),
    "textured_color": (lambda: _edit(lambda s: s["materials"][0]["param"].update(
        color={"fn": "wood.png"})), "slice 1b"),
    "normal_map": (lambda: _edit(lambda s: s["materials"][0]["param"].update(
        bump={"fn": "n.png"})), "slice 4"),
    "point_light": (lambda: _edit(lambda s: s["light_sampler"]["param"].update(
        lights=[{"type": "point", "param": {"position": [0, 1, 0]}}])),
        "slice 1b"),
    "hero_spectrum": (lambda: _edit(lambda s: s.update(
        spectrum={"type": "hero", "param": {"dimension": 4}})), "slice 4"),
    "media": (lambda: _edit(lambda s: s.update(mediums={
        "process": True, "global": "fog", "list": [
            {"type": "homogeneous", "name": "fog", "param": {}}]})),
        "slice 4"),
    "light_field": (lambda: _edit(lambda s: s.update(pipeline={
        "param": {"frame_buffer": {"type": "light_field"}}})), "slice 4"),
    "mesh_file": (lambda: _edit(lambda s: _shape(s, {
        "type": "model", "param": {"fn": "bunny.obj"}})), "slice 7"),
}

# scenes outside the dense sweep's slice, which now load through their
# BVH: a flat soup of > 2048 tris (K2) and a repeated heavy mesh (K3)
BVH_SCENES = {
    "over_2048_tris": (lambda: _edit(lambda s: _shape(s, _sphere(40))),
                       "pbvh"),
    "instanced_meshes": (lambda: _edit(lambda s: [
        _shape(s, _sphere(10, x)) for x in (-0.6, -0.2, 0.2, 0.6)]),
        "ipbvh"),
}


@pytest.mark.parametrize("name", sorted(OUT_OF_SLICE) + sorted(BVH_SCENES))
def test_out_of_slice_raises(name):
    """A feature outside the ported slices raises NotImplementedError
    naming its slice; the two scenes of BVH_SCENES, out of the slice before
    slices 2 and 3, load and carry the tree their kernel walks."""
    if name in BVH_SCENES:
        make, field = BVH_SCENES[name]
        ps = vt.load_scene(make(), device="cpu")
        assert getattr(ps.data, field) is not None
        assert (ps.data.pbvh is None) != (ps.data.ipbvh is None)
        return
    make, where = OUT_OF_SLICE[name]
    with pytest.raises(NotImplementedError, match=where):
        vt.load_scene(make(), device="cpu")


def test_adaptive_raises():
    with pytest.raises(NotImplementedError, match="slice 4"):
        vt.render(vt.load_scene(cbox(8), device="cpu"), spp=1, adaptive=True)


def test_instancing_threshold_matches_jax():
    """Three 360-tri spheres stay flat in both packages (the JAX package
    instances only when duplication costs >= 1024 tris)."""
    s = _edit(lambda s: [_shape(s, _sphere(10, x)) for x in (-0.5, 0.0, 0.5)])
    ps = vt.load_scene(s, device="cpu")
    js = JScene(s)
    assert js.data.ipbvh is None and js.data.pbvh is None
    np.testing.assert_array_equal(np_(ps.data.tri_pack),
                                  np.asarray(js.data.tri_pack))


@pytest.mark.parametrize("fn", ["load_scene", "Scene", "scene_from_arrays",
                                "render_to_file"])
def test_entry_points_default_to_the_card(fn):
    """The entry points run on the card unless the caller asks for the CPU:
    their `device` parameter defaults to "cuda" (read from the signature,
    no card needed)."""
    import inspect
    from vision_tpu_torch.scene import scene as tscene
    f = {"load_scene": vt.load_scene, "Scene": tscene.Scene,
         "scene_from_arrays": scene_from_arrays,
         "render_to_file": vt.render_to_file}[fn]
    assert inspect.signature(f).parameters["device"].default == "cuda"
