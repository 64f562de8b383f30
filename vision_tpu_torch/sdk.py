"""Embedding SDK: build a scene from arrays in code and render it.

Counterpart of `vision_tpu/sdk.py` `VisionRenderer` (add_material,
add_instance, add_light, set_camera, build_accel, render,
download_radiance, download_image): a host application feeds meshes,
materials and lights without a scene file. The meshes reach the scene
build as `Scene(..., meshes=)`, one `__sdk__` shape each (the JAX package
patches `shapes.make_shape` for this). Runs on `device`, the card unless
the caller asks for another.
"""
from __future__ import annotations

import numpy as np
import torch

from .render import _render_pass, postprocess
from .scene.scene import Scene
from .scene.shapes import TriMesh
from .sensor import film


class VisionRenderer:
    """Immediate-mode scene assembly, then a progressive render."""

    def __init__(self, resolution=(512, 512), device="cuda"):
        self._meshes = []  # dict(positions, normals, uvs, triangles, material, o2w, emission)
        self._materials = []
        self._lights = []
        self._camera = None
        self._resolution = tuple(resolution)
        self._device = device
        self._scene = None
        self._accum = None
        self._frame = 0

    def add_material(self, desc):
        """desc: a material description (scene JSON). Returns its name."""
        name = desc.get("name") or f"_sdk_mat_{len(self._materials)}"
        self._materials.append(dict(desc, name=name))
        return name

    def add_instance(self, positions, triangles, normals=None, uvs=None,
                     material=None, o2w=None, emission=None):
        """A triangle mesh (positions [V, 3], triangles [T, 3]; zero normals
        and uvs by default), its material name, its object-to-world 4x4
        (column vectors) and an emission colour. Returns its index."""
        positions = np.asarray(positions, np.float32)
        if normals is None:
            normals = np.zeros_like(positions)
        if uvs is None:
            uvs = np.zeros((len(positions), 2), np.float32)
        self._meshes.append(dict(
            positions=positions, triangles=np.asarray(triangles, np.int32),
            normals=np.asarray(normals, np.float32),
            uvs=np.asarray(uvs, np.float32),
            material=material, o2w=o2w, emission=emission))
        return len(self._meshes) - 1

    def add_light(self, desc):
        self._lights.append(desc)

    def set_camera(self, position, target, up=(0, 1, 0), fov_y=35.0,
                   lens_radius=0.0, focal_distance=5.0):
        self._camera = dict(position=list(position), target=list(target),
                            up=list(up), fov_y=fov_y, lens_radius=lens_radius,
                            focal_distance=focal_distance)

    def build_accel(self, **scene_overrides):
        """Build the scene on the device (its geometry path as any scene's:
        the dense sweep, the BVH). `scene_overrides` replace top-level
        blocks of the scene description."""
        cam = self._camera or dict(position=[0, 1, 5], target=[0, 1, 0],
                                   up=[0, 1, 0], fov_y=35.0,
                                   lens_radius=0.0, focal_distance=5.0)
        raw = {
            "shapes": [],
            "materials": self._materials,
            "camera": {"type": "thin_lens", "param": {
                "fov_y": cam["fov_y"],
                "lens_radius": cam["lens_radius"],
                "focal_distance": cam["focal_distance"],
                "transform": {"type": "look_at", "param": {
                    "position": cam["position"], "target_pos": cam["target"],
                    "up": cam["up"]}},
                "radiance_collector": {"type": "normal", "param": {
                    "resolution": list(self._resolution)}},
                "filter": {"type": "box", "param": {"radius": [0.5, 0.5]}},
            }},
            "integrator": {"type": "pt", "param": {"max_depth": 8}},
            "light_sampler": {"type": "uniform",
                              "param": {"lights": self._lights}},
            "sampler": {"type": "independent", "param": {"spp": 1}},
            "output": {"spp": 64, "fn": "sdk_out.png"},
        }
        raw.update(scene_overrides)
        for m in self._meshes:
            entry = {"type": "__sdk__", "param": {}}
            if m["material"]:
                entry["param"]["material"] = m["material"]
            if m["o2w"] is not None:
                entry["param"]["transform"] = {
                    "type": "matrix4x4",
                    "param": {"matrix4x4": np.asarray(m["o2w"]).T.tolist()}}
            if m["emission"] is not None:
                entry["param"]["emission"] = {
                    "type": "area",
                    "param": {"color": list(m["emission"]), "scale": 1}}
            raw["shapes"].append(entry)
        meshes = [TriMesh(m["positions"], m["normals"], m["uvs"],
                          m["triangles"]) for m in self._meshes]
        self._scene = Scene(raw, self._device, scene_dir=".", meshes=meshes)
        self._accum = None
        self._frame = 0
        return self

    def render(self, spp=1):
        """Advance the progressive render by `spp` samples, one pass each."""
        if self._scene is None:
            raise RuntimeError("call build_accel() first")
        sc = self._scene
        for _ in range(spp):
            img, _ = _render_pass(sc.data, sc.camera, sc.filter, self._frame,
                                  sc.max_depth, sc.min_depth, sc.rr_threshold)
            self._accum = img if self._accum is None else film.accumulate(
                self._accum, img, float(self._frame))
            self._frame += 1
        return self

    def download_radiance(self):
        """The linear HDR accumulation [H, W, 3] (numpy float32)."""
        if self._accum is None:
            raise RuntimeError("render() first")
        return self._accum.cpu().numpy()

    def download_image(self):
        """The tonemapped display image [H, W, 3] in [0, 1] (numpy)."""
        hdr = torch.as_tensor(self.download_radiance())
        return postprocess(self._scene, hdr).numpy()
