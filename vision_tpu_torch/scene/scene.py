"""Scene: JSON description -> flat SceneData of tensors on one device.

Counterpart of `vision_tpu/scene/scene.py` (`_build`, `_add_light`,
`_flatten`, `_pack_rows`, `_build_instanced`, `_build_device_geometry`):
procedural shapes (quad, cube, sphere) and mesh files (the `model` shape:
OBJ, PLY, STL, glTF; `shapes.py`, `gltf.py`), whole glTF / GLB scenes
(`Scene("x.glb")`, imported by `gltf.load_gltf_scene`), every material
type of `shading/materials.py`, area emission (on a shape or as a
standalone area light), point, spot, projector, spherical and directional
lights, the srgb and hero spectra (`spectrum.type`, `param.dimension`),
homogeneous participating media (the `mediums` block: `process`, `list`,
`global`; a shape's `medium.inside` / `outside`, the outside defaulting to
the global medium; a subsurface material's interior medium; the camera in
the global medium), images (textured and node-graph material slots, normal
maps, textured emission, projector images, spherical environment maps and
the `mix` environment, which blends two maps at load time, all packed into
one texture atlas; `scene/imageio.py` decodes PNG, JPEG, BMP, TGA, TIFF,
GIF, Radiance .hdr and OpenEXR, picked by extension as in the JAX
package), IES profiles on spot and projector lights, and
the normal and light-field frame buffers (`framebuffer_type`, `lf_grid`).
A mesh file that cannot be read skips its shape with a warning, and an
image that cannot be read takes its slot's default with a warning, as in
the JAX package; a spherical light whose image is missing, in a scene with
no other light, becomes the JAX package's substitute: a unit sky in the
light's frame. Identical geometry (the same procedural parameters, the
same file, node and primitive) loads once. Geometry takes the path the
JAX package gives it:

  * at most 2048 triangles: the dense sweep (kernel K1);
  * more: a SAH BVH over the flat soup (`pbvh`, kernel K2);
  * a mesh used at least twice whose copies would cost >= 1024 triangles
    (and has >= 64): one object-space copy per unique mesh under a TLAS of
    instances, the rest of the scene as one last identity instance
    (`ipbvh`, kernel K3). VT_INSTANCING=0 turns this off, as it does in
    the JAX package.

A feature outside the ported slices raises NotImplementedError naming the
ROADMAP slice that brings it, so a scene never quietly takes a path the
JAX package would not take.
"""
from __future__ import annotations

import os
import warnings
from collections import Counter
from dataclasses import dataclass, fields

import numpy as np
import torch

from ..accel.packet_bvh import (build_instanced_pbvh, build_packet_bvh,
                                instanced_pbvh_from_arrays,
                                packet_bvh_from_arrays)
from ..core import transform as xf
from ..lights.ies import IESProfile
from ..lights.lights import LightBuilder, LightTable
from ..sensor.camera import Camera
from ..sensor.filters import FilterSampler
from ..shading.materials import (COLUMNS, INT_COLUMNS, OPTIONAL,
                                 MaterialCompiler, MaterialTable)
from ..shading.medium import MediumBuilder, MediumTable
from ..shading.shader_graph import SlotValue
from ..spectra.spectrum import SpectrumModel
from . import desc as dsc
from . import shapes as shp
from .gltf import load_gltf_scene
from .texture import AtlasBuilder, TextureAtlas, load_image

BRUTE_FORCE_MAX_TRIS = 2048


@dataclass
class SceneData:
    """Everything the integrator reads, as tensors on one device."""
    tri_geom: torch.Tensor    # [T, 9] p0 e1 e2 of the world soup (K1's input)
    tri_pack: torch.Tensor    # [T, 32] p0 e1 e2 n0 n1 n2 uv0 uv1 uv2 inst mat light
    inst_mat: torch.Tensor    # [I] int32
    inst_light: torch.Tensor  # [I] int32 (-1 = not emissive)
    materials: MaterialTable
    lights: LightTable
    atlas: TextureAtlas
    spectrum: SpectrumModel
    world_radius: float
    ray_offset: float         # render_setting.ray_offset_factor
    mediums: MediumTable = None
    inst_in_medium: torch.Tensor = None   # [I] int32 (-1 vacuum)
    inst_out_medium: torch.Tensor = None  # [I] int32
    has_media: bool = False   # a Python switch: no medium op without it
    camera_medium: int = -1
    pbvh: object = None       # PacketBVH of the flat soup (> 2048 tris, K2)
    # instanced geometry (K3): tri_pack rows are then [unique meshes in
    # object space][the residual world soup], and hits carry an instance
    ipbvh: object = None              # InstancedPBVH
    inst_scene: torch.Tensor = None   # [It] TLAS instance -> scene instance (-1 residual)
    inst_xform: torch.Tensor = None   # [It, 32] o2w linear(9) t(3) normal matrix(9)


def _pack_rows(t, inst_mat=None, inst_light=None):
    """Packed per-triangle attribute rows (scene.py `_pack_rows`); the id
    columns stay 0 without `inst_mat` (an instanced mesh's rows)."""
    n = max(len(t["p0"]), 1)
    tp = np.zeros((n, 32), np.float32)
    if len(t["p0"]):
        for k, lo in (("p0", 0), ("e1", 3), ("e2", 6), ("n0", 9), ("n1", 12),
                      ("n2", 15), ("uv0", 18), ("uv1", 20), ("uv2", 22)):
            tp[:, lo:lo + t[k].shape[1]] = t[k]
        if inst_mat is not None:
            tp[:, 24] = t["inst"].astype(np.float32)
            tp[:, 25] = inst_mat[t["inst"]].astype(np.float32)
            tp[:, 26] = inst_light[t["inst"]].astype(np.float32)
    return tp


def _mesh_rows(mesh):
    """A mesh's per-triangle columns, as `_flatten` gives them."""
    tr = mesh.triangles
    p0, p1, p2 = (mesh.positions[tr[:, k]] for k in range(3))
    out = dict(p0=p0, e1=p1 - p0, e2=p2 - p0)
    for k in range(3):
        out[f"n{k}"] = mesh.normals[tr[:, k]]
        out[f"uv{k}"] = mesh.uvs[tr[:, k]]
    return out, (p0, p1, p2)


def _flatten(mesh_parts):
    """World meshes -> per-triangle attribute arrays (scene.py `_flatten`)."""
    cols = {k: [] for k in ("p0", "e1", "e2", "n0", "n1", "n2",
                            "uv0", "uv1", "uv2", "inst")}
    for world, inst_id in mesh_parts:
        t = world.triangles
        p0, p1, p2 = (world.positions[t[:, k]] for k in range(3))
        cols["p0"].append(p0)
        cols["e1"].append(p1 - p0)
        cols["e2"].append(p2 - p0)
        for k in range(3):
            cols[f"n{k}"].append(world.normals[t[:, k]])
            cols[f"uv{k}"].append(world.uvs[t[:, k]])
        cols["inst"].append(np.full(len(t), inst_id, np.int32))
    out = {}
    for k, xs in cols.items():
        if k == "inst":
            out[k] = np.concatenate(xs, 0) if xs else np.zeros((0,), np.int32)
        else:
            width = 2 if k.startswith("uv") else 3
            out[k] = (np.concatenate(xs, 0).astype(np.float32) if xs
                      else np.zeros((0, width), np.float32))
    return out


def _soup_points(t):
    return np.concatenate([t["p0"], t["p0"] + t["e1"], t["p0"] + t["e2"]], 0)


def _world_radius(p_all):
    if not len(p_all):
        return 1.0
    center = 0.5 * (p_all.min(0) + p_all.max(0))
    return max(float(np.linalg.norm(p_all - center, axis=-1).max()), 1e-3)


def _add_image(atlas, scene_dir, payload, default_cs, what):
    """An image slot's atlas id; -1 with a warning when its file cannot be
    read (the JAX package skips such an image the same way). An image
    format this package does not decode raises NotImplementedError."""
    try:
        return atlas.add_image(os.path.join(scene_dir, payload["fn"]),
                               payload.get("color_space", default_cs))
    except NotImplementedError:
        raise
    except Exception as e:
        warnings.warn(f"{what} missing: {e}")
        return -1


def _emission_color(edesc, atlas, scene_dir):
    """Emission desc -> (rgb * scale, two_sided, atlas id | -1). A textured
    emission's constant is white times the scale."""
    ep = dsc.ParameterSet(edesc.get("param", {}))
    kind, payload, _ = dsc.parse_slot(ep.raw("color", [1, 1, 1]))
    tex = -1
    if kind == "image":
        tex = _add_image(atlas, scene_dir, payload, "srgb", "emission texture")
    color = payload if kind == "const" else [1.0, 1.0, 1.0]
    color = list(color) + [color[-1]] * (3 - len(color))
    sk, sp_, _ = dsc.parse_slot(ep.raw("scale", 1.0))
    scale = sp_[0] if sk == "const" else 1.0
    return [c * scale for c in color[:3]], ep.as_bool("two_sided", False), tex


def _ies_id(lights, p, scene_dir):
    """The IES profile of a spot or projector light (-1 without one, or
    with a warning when its file is unusable)."""
    fn = p.raw("ies", None)
    if not fn:
        return -1
    try:
        prof = IESProfile.load(os.path.join(scene_dir, fn))
        return lights.add_ies_profile(prof.to_table())
    except Exception as e:
        warnings.warn(f"ies profile '{fn}' unusable: {e}")
        return -1


def _add_mix_env(lights, atlas, p, scene_dir):
    """The `mix` environment: scale0 env0 + scale1 env1 combined at load
    time into one spherical light, resampled by nearest index to the larger
    resolution, in env0's frame."""
    def load_env(key, skey):
        sub = p.raw(key, {}) or {}
        sp_ = dsc.ParameterSet(sub.get("param", {}))
        kind, payload, _ = dsc.parse_slot(sp_.raw("color", [1, 1, 1]))
        if kind != "image":
            return None
        try:
            img = load_image(os.path.join(scene_dir, payload["fn"]),
                             payload.get("color_space", "linear"))
        except NotImplementedError:
            raise
        except Exception:
            return None
        scale = p.as_float(skey, 1.0) * sp_.as_float("scale", 1.0)
        return img, scale, xf.from_json(sp_.raw("o2w"))

    e0 = load_env("env0", "scale0")
    e1 = load_env("env1", "scale1")
    if e0 is None and e1 is None:
        return
    if e0 is None or e1 is None:
        img, scale, o2w = e0 or e1
        combined = img * scale
    else:
        h = max(e0[0].shape[0], e1[0].shape[0])
        w = max(e0[0].shape[1], e1[0].shape[1])
        combined = (SlotValue(image=e0[0]).as_image(h, w) * e0[1]
                    + SlotValue(image=e1[0]).as_image(h, w) * e1[1])
        o2w = e0[2]
    tex = atlas.add_array(combined.astype(np.float32))
    lights.add_spherical([1.0, 1.0, 1.0], o2w, tex, combined)


def _add_light(lights, atlas, ldesc, scene_dir, add_area):
    """One entry of light_sampler.lights (the JAX package's `_add_light`).
    Returns the (color, o2w) of a spherical light whose image is missing,
    else None; `add_area(color, two_sided, world_quad)` adds an area
    light's geometry and row."""
    lt = ldesc.get("type")
    p = dsc.ParameterSet(ldesc.get("param", {}))
    scale = p.as_float("scale", 1.0)
    kind, payload, _ = dsc.parse_slot(p.raw("color", [1, 1, 1]))
    if kind == "const":
        c = payload + [payload[-1]] * (3 - len(payload))
        color, img = [v * scale for v in c[:3]], None
    else:
        color, img = [scale] * 3, (payload if kind == "image" else None)
    if lt == "point":
        lights.add_point(color, p.as_float3("position"))
    elif lt == "spot":
        lights.add_spot(color, p.as_float3("position"),
                        p.as_float3("direction", (0, 0, 1)),
                        p.as_float("angle", 45.0), p.as_float("falloff", 10.0),
                        ies=_ies_id(lights, p, scene_dir))
    elif lt == "projector":
        tex = -1
        if img is not None:
            tex = _add_image(atlas, scene_dir, img, "srgb", "projector texture")
        lights.add_projector(color, xf.from_json(p.raw("o2w")),
                             p.as_float("angle", 30.0),
                             p.as_float("ratio", 1.0), tex,
                             ies=_ies_id(lights, p, scene_dir))
    elif lt == "spherical":
        if img is None:
            return None  # a constant-color environment is skipped
        tex = _add_image(atlas, scene_dir, img, "linear", "spherical light")
        if tex < 0:
            return color, p.raw("o2w")
        lights.add_spherical(color, xf.from_json(p.raw("o2w")), tex,
                             atlas.images[tex])
    elif lt == "directional":
        lights.add_directional(color, p.as_float3("direction", (0, -1, 0)))
    elif lt == "mix":
        _add_mix_env(lights, atlas, p, scene_dir)
    elif lt == "area":
        world = shp.make_quad(p.as_float("width", 1.0),
                              p.as_float("height", 1.0)).transformed(
            xf.from_json(p.raw("o2w")))
        add_area(color, p.as_bool("two_sided", False), world)
    return None


class Scene:
    """Host-side scene container (load + build) on `device`, the card
    unless the caller asks for another. A `.gltf` / `.glb` path imports the
    whole file (`gltf.load_gltf_scene`); any other path is scene JSON(C).
    `meshes` are TriMesh objects for the shapes of type `__sdk__`, the
    i-th such shape taking meshes[i] (the SDK's way in)."""

    def __init__(self, path_or_dict, device="cuda", scene_dir=None,
                 meshes=()):
        if isinstance(path_or_dict, (str, os.PathLike)):
            p = os.fspath(path_or_dict)
            if p.lower().endswith((".gltf", ".glb")):
                raw = load_gltf_scene(p)
            else:
                raw = dsc.load_jsonc(p)
            self.scene_dir = scene_dir or os.path.dirname(os.path.abspath(p))
        else:
            raw = path_or_dict
            self.scene_dir = scene_dir or "."
        self.raw = raw
        self.device = torch.device(device)
        self._build(list(meshes))

    def _build(self, sdk_meshes):
        raw, device = self.raw, self.device
        atlas = AtlasBuilder()
        mats = MaterialCompiler(atlas, self.scene_dir)
        for mdesc in raw.get("materials", []):
            mats.compile(mdesc)

        # ---- mediums: {process, list, global} ----
        media = MediumBuilder()
        med_desc = raw.get("mediums", {})
        process_media = bool(med_desc.get("process", False))
        for mdesc in med_desc.get("list", []):
            media.add(mdesc)
        gname = med_desc.get("global", "")
        global_medium = media.get(gname) if gname else -1
        inst_media = []  # (inside, outside) per instance

        def sss_medium(mid, sss):
            """The interior medium of subsurface material `mid`, made once
            (the JAX package's `_obtain_sss_medium`)."""
            nonlocal process_media
            key = f"__sss_{mid}"
            if media.get(key) >= 0:
                return media.get(key)
            param = {"sigma_a": sss["sigma_a"], "sigma_s": sss["sigma_s"],
                     "g": sss["g"]}
            if sss.get("medium_name"):
                param = {"medium_name": sss["medium_name"], "g": sss["g"]}
            process_media = True
            return media.add({"type": "homogeneous", "name": key,
                              "param": param})

        fb = raw.get("pipeline", {}).get("param", {}).get("frame_buffer", {})
        # the frame buffer: "light_field" renders an S x S grid of
        # sub-aperture views (`render.render_light_field`)
        self.framebuffer_type = fb.get("type", "normal")
        self.lf_grid = int(fb.get("param", {}).get("grid", 3))
        # the pipeline the scene asks for ("fixed", "customized" = the
        # render graph, "bake"); the CLI's -p overrides it
        self.pipeline_type = raw.get("pipeline", {}).get("type", "fixed")
        sp_desc = raw.get("spectrum", {})
        sp_type = sp_desc.get("type", "srgb")
        sp_dims = sp_desc.get("param", {}).get("dimension", 3)
        if sp_type not in ("srgb", "hero"):
            sp_type = "srgb"  # the JAX package reads any other name as srgb

        ls = raw.get("light_sampler", {})
        lights = LightBuilder(sampler_type=ls.get("type", "uniform"),
                              env_prob=ls.get("param", {}).get("env_prob", 0.5))

        # ---- shapes: the mesh registry (identical geometry loads once); a
        # mesh file that cannot be read skips its shape ----
        raw_parts = []  # (mesh, o2w, inst_id, geo_key, emission|None)
        inst_mat, inst_light = [], []
        mesh_cache = {}
        sdk_meshes = iter(sdk_meshes)
        for sdesc in raw.get("shapes", []):
            stype = sdesc.get("type", "quad")
            p = sdesc.get("param", {})
            key = shp.geometry_key(stype, p, self.scene_dir)
            try:
                if stype == "__sdk__":
                    mesh = next(sdk_meshes, None)
                    if mesh is None:
                        raise ValueError("an __sdk__ shape without its mesh")
                else:
                    mesh = mesh_cache.get(key)
                    if mesh is None:
                        mesh = shp.make_shape(stype, p, self.scene_dir)
                        if key is not None:
                            mesh_cache[key] = mesh
            except (FileNotFoundError, ValueError) as e:
                warnings.warn(f"skipping shape '{sdesc.get('name')}': {e}")
                continue
            mat_name = p.get("material")
            if isinstance(mat_name, dict):
                mid = mats.compile(mat_name)
            else:
                mid = mats.get(mat_name) if mat_name else -1
            inst_id = len(inst_mat)
            inst_mat.append(mid)
            inst_light.append(-1)
            med = p.get("medium", {})
            inside = media.get(med.get("inside", "")) if med else -1
            outside = (media.get(med.get("outside", "")) if med
                       else global_medium)
            sss = mats.sss.get(mid)
            if sss is not None and inside < 0:
                inside = sss_medium(mid, sss)
            inst_media.append((inside, outside))
            raw_parts.append((mesh, xf.from_json(p.get("transform")), inst_id,
                              key, p.get("emission")))

        # ---- instancing: a mesh used >= 2x whose copies would cost >= 1024
        # tris keeps one object-space copy under the TLAS; everything else
        # flattens to the world-space residual. Triangle numbering is
        # [unique meshes][residual], so light tri_base offsets start after
        # the unique meshes ----
        counts = Counter(k for (_, _, _, k, em) in raw_parts
                         if k is not None and em is None)
        dedup_keys = set()
        if os.environ.get("VT_INSTANCING", "1") != "0":
            for k, c in counts.items():
                nt = mesh_cache[k].num_triangles
                if c >= 2 and nt >= 64 and (c - 1) * nt >= 1024:
                    dedup_keys.add(k)
        dedup_meshes, dedup_instances, key_to_midx = [], [], {}
        for (mesh, m, inst_id, key, emission) in raw_parts:
            if key in dedup_keys and emission is None:
                if key not in key_to_midx:
                    key_to_midx[key] = len(dedup_meshes)
                    dedup_meshes.append(mesh)
                dedup_instances.append((key_to_midx[key], m, inst_id))

        mesh_parts, pending = [], []
        base = sum(m_.num_triangles for m_ in dedup_meshes)
        for (mesh, m, inst_id, key, emission) in raw_parts:
            if key in dedup_keys and emission is None:
                continue
            world = mesh.transformed(m)
            mesh_parts.append((world, inst_id))
            if emission is not None:
                pending.append((inst_id, emission, base, _tri_areas(world)))
            base += world.num_triangles

        # ---- lights ----
        def add_area(color, two_sided, world):
            nonlocal base
            inst_id = len(inst_mat)
            inst_mat.append(-1)
            inst_media.append((-1, global_medium))
            inst_light.append(lights.add_area(color, inst_id, base,
                                              _tri_areas(world), two_sided))
            mesh_parts.append((world, inst_id))
            base += world.num_triangles

        skipped_env = None
        for ldesc in ls.get("param", {}).get("lights", []):
            skipped_env = _add_light(lights, atlas, ldesc, self.scene_dir,
                                     add_area) or skipped_env
        for inst_id, edesc, tri_base, areas in pending:
            color, two_sided, tex = _emission_color(edesc, atlas,
                                                    self.scene_dir)
            inst_light[inst_id] = lights.add_area(color, inst_id, tri_base,
                                                  areas, two_sided, tex)
        if skipped_env is not None and not lights.rows:
            # the only light was an environment whose image is missing: a
            # constant unit sky in its frame keeps the scene lit, as in the
            # JAX package
            warnings.warn("scene has no lights; substituting a constant "
                          "environment for the missing HDRI")
            image = np.full((8, 16, 3), 1.0, np.float32)
            lights.add_spherical([1.0, 1.0, 1.0], xf.from_json(skipped_env[1]),
                                 atlas.add_array(image), image)

        # ---- flatten geometry ----
        t = _flatten(mesh_parts)
        inst_mat = np.asarray(inst_mat, np.int32)
        inst_light = np.asarray(inst_light, np.int32)
        geo = dict(pbvh=None, ipbvh=None, inst_scene=None, inst_xform=None)
        if dedup_meshes:
            tri_pack, p_all, inst_geo = _build_instanced(
                dedup_meshes, dedup_instances, t, inst_mat, inst_light, device)
            geo.update(inst_geo)
        else:
            tri_pack, p_all = _pack_rows(t, inst_mat, inst_light), _soup_points(t)
            if len(t["p0"]) > BRUTE_FORCE_MAX_TRIS:
                geo["pbvh"] = build_packet_bvh(t["p0"], t["p0"] + t["e1"],
                                               t["p0"] + t["e2"], device)

        # ---- camera, filter, integrator, output ----
        cam = raw.get("camera", {})
        cp = dsc.ParameterSet(cam.get("param", {}))
        rc = cp.raw("radiance_collector", cp.raw("film", {})) or {}
        rc_param = rc.get("param", {}) if isinstance(rc, dict) else {}
        res = rc_param.get("resolution", [512, 512])
        if not rc_param and fb:
            res = fb.get("param", {}).get("resolution", res)
        self.resolution = (int(res[0]), int(res[1]))
        self.camera = Camera.make(
            xf.from_json(cp.raw("transform")), cp.as_float("fov_y", 20.0),
            self.resolution, device, lens_radius=cp.as_float("lens_radius", 0.0),
            focal_distance=cp.as_float("focal_distance", 5.0))
        tm = rc_param.get("tone_mapper", {})
        self.tone_mapper = tm.get("type", "linear")
        self.exposure = tm.get("param", {}).get("exposure", 1.0)
        fdesc = cam.get("param", {}).get("filter", {"type": "box"})
        self.filter = FilterSampler.make(fdesc.get("type", "box"),
                                         fdesc.get("param", {}), device)

        ip = dsc.ParameterSet(raw.get("integrator", {}).get("param", {}))
        self.max_depth = ip.as_int("max_depth", 16)
        self.min_depth = ip.as_int("min_depth", 0)
        self.rr_threshold = ip.as_float("rr_threshold", 1.0)
        out = raw.get("output", {})
        self.output_spp = int(out.get("spp", 0))
        self.output_fn = out.get("fn", "output.png")
        rs = dsc.ParameterSet(raw.get("render_setting", {}))

        def media_col(k):
            return torch.as_tensor(
                np.asarray([m[k] for m in inst_media] or [-1], np.int32),
                device=device)

        self.data = SceneData(
            tri_geom=torch.as_tensor(
                np.concatenate([t["p0"], t["e1"], t["e2"]], 1), device=device),
            tri_pack=torch.as_tensor(tri_pack, device=device),
            inst_mat=torch.as_tensor(inst_mat, device=device),
            inst_light=torch.as_tensor(inst_light, device=device),
            materials=mats.build(device), lights=lights.build(device),
            atlas=atlas.build(device),
            spectrum=SpectrumModel.make(sp_type, sp_dims, device),
            world_radius=float(np.float32(_world_radius(p_all))),
            ray_offset=float(np.float32(rs.as_float("ray_offset_factor", 1.0))),
            mediums=media.build(device), inst_in_medium=media_col(0),
            inst_out_medium=media_col(1),
            has_media=process_media and len(media.rows) > 0,
            camera_medium=global_medium, **geo)


def _build_instanced(meshes, instances, t, inst_mat, inst_light, device):
    """TLAS/BLAS geometry (scene.py `_build_instanced`): each unique mesh's
    rows once in object space, then the residual world soup, which rides
    along as the last instance with an identity transform (its rows keep
    their inst / mat / light ids, so emissive triangles work unchanged).
    Returns (tri_pack, the points that bound the world, the SceneData
    fields ipbvh, inst_scene and inst_xform)."""
    tris, packs = [], []
    for mesh in meshes:
        rows, ps = _mesh_rows(mesh)
        tris.append(ps)
        packs.append(_pack_rows(rows))
    tris.append((t["p0"], t["p0"] + t["e1"], t["p0"] + t["e2"]))
    packs.append(_pack_rows(t, inst_mat, inst_light))
    # scene transforms are in column form; the TLAS builder and inst_xform
    # take row-vector form (world = p @ m[:3, :3] + m[3, :3])
    insts = ([(mi, np.asarray(m, np.float64).T) for (mi, m, _) in instances]
             + [(len(meshes), np.eye(4))])
    ipbvh = build_instanced_pbvh(tris, insts, device)
    xf_rows = np.zeros((len(insts), 32), np.float32)
    for i, (_, m) in enumerate(insts):
        L = m[:3, :3]
        xf_rows[i, 0:9] = L.reshape(-1)
        xf_rows[i, 9:12] = m[3, :3]
        xf_rows[i, 12:21] = np.linalg.inv(L).T.reshape(-1)  # n @ inv(L).T
    inst_scene = np.array([sid for (_, _, sid) in instances] + [-1], np.int32)
    pts = [_soup_points(t)]
    for (mi, m, _) in instances:
        P = meshes[mi].positions
        lo, hi = P.min(0), P.max(0)
        cs = np.array([[x, y, z] for x in (lo[0], hi[0])
                       for y in (lo[1], hi[1]) for z in (lo[2], hi[2])])
        mm = np.asarray(m, np.float64).T
        pts.append((cs @ mm[:3, :3] + mm[3, :3]).astype(np.float32))
    geo = dict(ipbvh=ipbvh,
               inst_scene=torch.as_tensor(inst_scene, device=device),
               inst_xform=torch.as_tensor(xf_rows, device=device))
    return (np.concatenate(packs, 0).astype(np.float32),
            np.concatenate(pts, 0), geo)


def _tri_areas(world):
    t0, t1, t2 = (world.positions[world.triangles[:, k]] for k in range(3))
    return 0.5 * np.linalg.norm(np.cross(t1 - t0, t2 - t0), axis=-1)


def load_scene(path_or_dict, device="cuda"):
    """Load a scene file or dict onto `device`: the card unless the caller
    asks for another (nothing probes for a card, nothing falls back)."""
    return Scene(path_or_dict, device)


def scene_from_arrays(arrays, device="cuda"):
    """The JAX package's scene state, each field as an array, -> this
    package's (SceneData, Camera, FilterSampler) on `device`. Every array
    is copied: a tensor never shares a buffer with the JAX scene.

    Keys: SceneData fields by name (`tri_p0`, `tri_e1`, `tri_e2`,
    `tri_pack`, `inst_mat`, `inst_light`, `world_radius`, `ray_offset`,
    `has_media`, `camera_medium`, `inst_in_medium`, `inst_out_medium`, and
    for an instanced scene `inst_scene`, `inst_xform`), and the fields of
    its records under a prefix: `materials.*` (MaterialTable, the spectral
    columns included), `mediums.*` (MediumTable), `lights.*` (LightTable),
    `atlas.*` (TextureAtlas), `spectrum.*` (SpectrumModel: `kind`, `dims`
    and its tables), `camera.*` (Camera), `filter.*` (FilterSampler),
    `pbvh.*` (PacketBVH) and `ipbvh.*` (InstancedPBVH). Static fields
    (`feats`, `n_lights`, `env_index`, `env_prob`, `env_w`, `env_h`,
    `n_real`, `kind`, `dims`, `resolution`, `is_box`, `bsize`,
    `has_media`, `camera_medium`) come as arrays too.
    """
    a = {k: np.array(v) for k, v in arrays.items()}

    def t(key, dtype=None):
        return torch.as_tensor(a[key], dtype=dtype, device=device)

    mat_feats = tuple(str(f) for f in np.atleast_1d(a["materials.feats"]))
    light_feats = tuple(str(f) for f in np.atleast_1d(a["lights.feats"]))

    materials = MaterialTable(
        feats=mat_feats,
        **{k: t(f"materials.{k}",
                torch.int32 if k in INT_COLUMNS else torch.float32)
           for k in COLUMNS},
        **{k: t(f"materials.{k}") for k in OPTIONAL
           if f"materials.{k}" in a})
    static = {"n_lights", "env_index", "env_prob", "env_w", "env_h", "feats"}
    lf = [f.name for f in fields(LightTable)
          if f.name not in static and f.name != "packed"]
    lights = LightTable(
        feats=light_feats, n_lights=int(a["lights.n_lights"]),
        env_index=int(a["lights.env_index"]),
        env_prob=float(a["lights.env_prob"]), env_w=int(a["lights.env_w"]),
        env_h=int(a["lights.env_h"]),
        **{k: t(f"lights.{k}", torch.int64 if k == "env_tex" else None)
           for k in lf})
    atlas = TextureAtlas(data=t("atlas.data"),
                         offset=t("atlas.offset", torch.int64),
                         width=t("atlas.width", torch.int64),
                         height=t("atlas.height", torch.int64),
                         n_real=int(a["atlas.n_real"]))
    spectrum = SpectrumModel(kind=int(a["spectrum.kind"]),
                             dims=int(a["spectrum.dims"]), **{
        k: t(f"spectrum.{k}") for k in ("coeffs", "cie_x", "cie_y", "cie_z",
                                        "d65n")})
    media = dict(has_media=bool(a.get("has_media", False)),
                 camera_medium=int(a.get("camera_medium", -1)))
    if "mediums.g" in a:
        media.update(
            mediums=MediumTable(**{k: t(f"mediums.{k}", torch.float32)
                                   for k in ("sigma_a", "sigma_s", "g")}),
            inst_in_medium=t("inst_in_medium", torch.int32),
            inst_out_medium=t("inst_out_medium", torch.int32))
    elif media["has_media"]:
        raise ValueError("a scene with media needs its mediums.* and "
                         "inst_*_medium")
    geo = dict(pbvh=None, ipbvh=None, inst_scene=None, inst_xform=None)
    for key, make in (("pbvh", packet_bvh_from_arrays),
                      ("ipbvh", instanced_pbvh_from_arrays)):
        sub = {k[len(key) + 1:]: v for k, v in a.items()
               if k.startswith(key + ".")}
        if sub:
            geo[key] = make(sub, device)
    if geo["ipbvh"] is not None:
        geo.update(inst_scene=t("inst_scene"), inst_xform=t("inst_xform"))
    elif geo["pbvh"] is None and a["tri_p0"].shape[0] > BRUTE_FORCE_MAX_TRIS:
        raise ValueError("a scene of more than "
                         f"{BRUTE_FORCE_MAX_TRIS} triangles needs its pbvh.*")
    data = SceneData(
        tri_geom=torch.as_tensor(np.concatenate(
            [a["tri_p0"], a["tri_e1"], a["tri_e2"]], 1), device=device),
        tri_pack=t("tri_pack"), inst_mat=t("inst_mat"),
        inst_light=t("inst_light"), materials=materials, lights=lights,
        atlas=atlas, spectrum=spectrum,
        world_radius=float(a["world_radius"]),
        ray_offset=float(a["ray_offset"]), **media, **geo)
    camera = Camera(c2w=t("camera.c2w"), tan_half_fov=t("camera.tan_half_fov"),
                    lens_radius=t("camera.lens_radius"),
                    focal_distance=t("camera.focal_distance"),
                    resolution=tuple(int(r) for r in a["camera.resolution"]))
    filt = FilterSampler(radius=t("filter.radius"), prob=t("filter.prob"),
                         alias=t("filter.alias"), pmf=t("filter.pmf"),
                         sign=t("filter.sign"), int_abs=t("filter.int_abs"),
                         is_box=bool(a["filter.is_box"]))
    return data, camera, filt
