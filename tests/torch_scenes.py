"""The two mesh scenes of the port's BVH path, built from the in-repo cornell
box (`tests/fixtures.py` CBOX_JSON), so nothing has to be downloaded.

  * `cbox_sphere`: the cbox plus one diffuse sphere (radius 0.3, sub_div
    256: 261,120 triangles) resting on the short box, 261,156 triangles in
    all. Above 2048 triangles a scene takes the BVH: flat traversal (K2).
  * `cbox_spheres_instanced`: the cbox plus 16 diffuse spheres (radius
    0.12, sub_div 128: 65,024 triangles each) on a 4x4 grid in front of the
    back wall; every other one is turned 0.6 rad about y. They share one
    mesh, so both packages instance it: TLAS -> per-mesh traversal (K3).
    Flattened, the spheres come to 1,040,384 triangles. Loaded with
    VT_INSTANCING=0 the same JSON is its flat twin.
  * `cbox_glass`: `tests/fixtures.py` `make_glass_cbox` (glass BK7 and
    mirror boxes; ladder config 2), 36 triangles: the dense sweep (K1).
  * `cbox_zoo`: `cbox_sphere(sub_div=40)` geometry (6,276 triangles, K2)
    with a material of every family on it (principled with clearcoat and
    sheen, substrate, a mix of rough copper and plastic, Oren-Nayar,
    F82 metallic, an add of diffuse and a rough mirror) lit by the
    ceiling emitter, a point, a spot and a constant-color projector under
    the power light sampler.
  * `cbox_sky`: the cbox without its emitter, lit through its open front
    by a spherical light whose HDRI file is missing, which both packages
    replace by a unit sky. 36 triangles, K1.
  * `cbox_glass_hero`: `cbox_glass` under the hero-wavelength spectrum of
    dimension 4 (ladder config 3's dispersive glass): the BK7 box's
    Sellmeier IOR per wavelength, K1.
  * `fog_cbox`: the cbox filled with a global homogeneous fog (sigma_s
    0.3, sigma_a 0.01, g 0; `tests/test_medium.py` `fog_cbox`), srgb, K1.
  * `cbox_sss`: the cbox whose tall box is a `subsurface` material (its
    default sigmas at `sigma_scale` 0.5, a mean free path of ~0.3-0.4
    scene units in a 0.6-unit-wide box: visibly translucent) under the
    hero spectrum of dimension 4, K1.
  * `cbox_tex`: the cbox with images and shade-time nodes (slices 4c and
    7a): the checker times a number (baked) on the floor and the back
    wall, the checker through a `vector_mapping` node and the bump map on
    the tall box, a fresnel-driven colour mix on the short box, an IES
    spot beside the area light, whose emission is the checker. 36
    triangles, K1.
  * `env_sphere`: a checkered uv sphere (sub_div 40: 6,240 triangles) on
    a ground quad, lit by the `mix` of two .hdr skies and a projector with
    an RGBA image. 6,242 triangles, K2.
  * `lf_cbox`: the cbox through a thin lens (radius 0.35, focal distance
    6) under the light-field frame buffer of grid 3.
  * `tex_wall_cbox`: the cbox whose back wall carries an 8x8 image
    (`wall_texture`), the texture-recovery scene of `tests/test_diff.py`.

The images and the IES profile are the files of `tests/assets_torch/`
(`tools/gen_torch_assets.py` writes them); the scenes name them by
absolute path.

This module loads `tests/fixtures.py` by path, and `chip_smoke.py` loads
this module by path: a `tests` package elsewhere on sys.path must not
shadow the repo's.
"""
import copy
import importlib.util
import math
import os

_spec = importlib.util.spec_from_file_location(
    "vt_cbox_fixtures", os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                     "fixtures.py"))
_fixtures = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_fixtures)
CBOX_JSON = _fixtures.CBOX_JSON

# the short box's top face is at y = 0.6 (fixtures.py _SHORT)
SPHERE_ROW = [0.33, 0.9, 0.37, 1]
GRID_X = (-0.6, -0.2, 0.2, 0.6)
GRID_Y = (0.3, 0.75, 1.2, 1.65)
GRID_Z = -0.85   # in front of the back wall (z = -1), behind the tall box


def _base(res):
    s = copy.deepcopy(CBOX_JSON)
    s["camera"]["param"]["radiance_collector"]["param"]["resolution"] = [res, res]
    return s


def _sphere(radius, sub_div, m):
    return {"type": "sphere", "param": {
        "radius": radius, "sub_div": sub_div, "material": "White",
        "transform": {"type": "matrix4x4", "param": {"matrix4x4": m}}}}


def cbox_sphere(res=512, sub_div=256):
    """The cbox with one white sphere resting on the short box."""
    s = _base(res)
    s["shapes"].append(_sphere(0.3, sub_div, [[1, 0, 0, 0], [0, 1, 0, 0],
                                              [0, 0, 1, 0], list(SPHERE_ROW)]))
    return s


def cbox_spheres_instanced(res=512, sub_div=128, radius=0.12):
    """The cbox with 16 spheres of one mesh on a 4x4 grid; the odd ones are
    turned 0.6 rad about y (row-vector matrices, translation in row 4)."""
    s = _base(res)
    c, sn = math.cos(0.6), math.sin(0.6)
    for i in range(16):
        row = [GRID_X[i % 4], GRID_Y[i // 4], GRID_Z, 1]
        lin = ([[c, 0, -sn, 0], [0, 1, 0, 0], [sn, 0, c, 0]] if i % 2
               else [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0]])
        s["shapes"].append(_sphere(radius, sub_div, lin + [row]))
    return s


def cbox_glass(res=512):
    """`make_glass_cbox` (ladder config 2) at res x res."""
    s = _fixtures.make_glass_cbox()
    s["camera"]["param"]["radiance_collector"]["param"]["resolution"] = [res, res]
    return s


ZOO_MATERIALS = [
    {"type": "principled_bsdf", "name": "Principled", "param": {
        "color": [0.75, 0.6, 0.35], "roughness": 0.4, "anisotropic": 0.3,
        "metallic": 0.1, "spec_tint": 0.2, "ior": 1.5, "sheen": 0.6,
        "sheen_tint": 0.5, "sheen_roughness": 0.4, "clearcoat": 0.7,
        "clearcoat_alpha": 0.1}},
    {"type": "substrate", "name": "Substrate", "param": {
        "color": [0.2, 0.4, 0.7], "spec": [0.06, 0.06, 0.06],
        "roughness": 0.3}},
    {"type": "mix", "name": "CuPlastic", "param": {
        "frac": 0.6,
        "mat0": {"type": "metal", "param": {"material_name": "Cu",
                                            "roughness": 0.3}},
        "mat1": {"type": "plastic", "param": {"color": [0.8, 0.2, 0.2],
                                              "roughness": 0.2,
                                              "ior": 1.5}}}},
    {"type": "diffuse", "name": "RedOren", "param": {
        "color": [0.63, 0.065, 0.05], "sigma": 20.0}},
    {"type": "metallic", "name": "GreenMetallic", "param": {
        "color": [0.3, 0.75, 0.3], "edge_tint": [0.9, 1.0, 0.9],
        "roughness": 0.35}},
    {"type": "add", "name": "DiffuseMirror", "param": {
        "mat0": {"type": "diffuse", "param": {"color": [0.45, 0.45, 0.45]}},
        "mat1": {"type": "mirror", "param": {"color": [0.3, 0.3, 0.3],
                                             "roughness": 0.3}}}},
]
# shapes of cbox_sphere: floor, ceiling, back, left, right, short, tall,
# the emitter, the sphere
ZOO_ASSIGN = {2: "DiffuseMirror", 3: "RedOren", 4: "GreenMetallic",
              5: "Substrate", 6: "Principled", 8: "CuPlastic"}
SPHERE_CENTER = SPHERE_ROW[:3]


def cbox_zoo(res=512, sub_div=40):
    """`cbox_sphere` geometry with every material family and every
    positional light type (point, spot on the sphere, constant-color
    projector) besides the ceiling emitter, selected by power."""
    s = cbox_sphere(res, sub_div)
    s["materials"] += copy.deepcopy(ZOO_MATERIALS)
    for i, name in ZOO_ASSIGN.items():
        s["shapes"][i]["param"]["material"] = name
    spot_pos = [0.33, 1.85, 1.1]
    s["light_sampler"] = {"type": "power", "param": {"lights": [
        {"type": "point", "param": {"color": [0.9, 0.8, 0.7], "scale": 1.0,
                                    "position": [-0.55, 1.55, 0.6]}},
        {"type": "spot", "param": {
            "color": [2.5, 2.5, 2.5], "scale": 1.0, "position": spot_pos,
            "direction": [c - p for c, p in zip(SPHERE_CENTER, spot_pos)],
            "angle": 22.0, "falloff": 8.0}},
        {"type": "projector", "param": {
            "color": [0.4, 0.7, 1.0], "scale": 1.5, "angle": 18.0,
            "ratio": 1.3,
            "o2w": {"type": "look_at", "param": {
                "position": [-0.7, 1.7, 1.2], "target_pos": [-0.3, 0.8, -0.6],
                "up": [0, 1, 0]}}}},
    ]}}
    return s


def cbox_sky(res=512):
    """The cbox without its emitter, lit through the open front by a
    spherical light whose HDRI file does not exist: the loader replaces it
    by a constant unit sky in the light's frame."""
    s = _base(res)
    s["shapes"].pop()  # the ceiling emitter
    s["light_sampler"] = {"type": "uniform", "param": {"lights": [
        {"type": "spherical", "param": {
            "color": {"fn": "__missing_sky__.exr"}, "scale": 3.0,
            "o2w": {"type": "matrix4x4", "param": {"matrix4x4": [
                [1, 0, 0, 0], [0, 0, -1, 0], [0, 1, 0, 0], [0, 0, 0, 1]]}}}}]}}
    return s


HERO = {"type": "hero", "param": {"dimension": 4}}


def cbox_glass_hero(res=512):
    """`cbox_glass` under the hero spectrum (dimension 4): dispersive BK7."""
    s = cbox_glass(res)
    s["spectrum"] = copy.deepcopy(HERO)
    return s


def fog_cbox(res=512, sigma_s=0.3, sigma_a=0.01):
    """The cbox in a global homogeneous fog (tests/test_medium.py
    `fog_cbox`), srgb."""
    s = _base(res)
    s["mediums"] = {
        "process": True,
        "global": "fog",
        "list": [{"type": "homogeneous", "name": "fog",
                  "param": {"g": 0.0, "sigma_s": [sigma_s] * 3,
                            "sigma_a": [sigma_a] * 3, "scale": 1.0}}],
    }
    return s


def cbox_sss(res=512):
    """The cbox whose tall box is a translucent subsurface material, under
    the hero spectrum: the interior medium decodes its sigmas per
    wavelength and is entered through `inst_in_medium`."""
    s = _base(res)
    s["materials"].append({"type": "subsurface", "name": "Subsurface",
                           "param": {"color": [1, 1, 1], "roughness": 0.2,
                                     "ior": 1.4, "sigma_scale": 0.5}})
    s["shapes"][6]["param"]["material"] = "Subsurface"
    s["spectrum"] = copy.deepcopy(HERO)
    return s


ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "assets_torch")


def asset(fn):
    return os.path.join(ASSETS, fn)


def cbox_tex(res=512):
    """The cbox with a baked image node, a uv-mapped image, a normal map,
    a fresnel-driven colour, an IES spot and a textured emitter."""
    s = _base(res)
    checker = {"fn": asset("checker.png"), "color_space": "srgb"}
    s["materials"] += [
        {"type": "diffuse", "name": "Checker", "param": {"color": {
            "type": "multiply", "param": {
                "lhs": checker,
                "rhs": {"type": "number", "param": {"value": [0.9, 0.85, 0.8]}}}}}},
        {"type": "diffuse", "name": "Mapped", "param": {
            "color": {"type": "vector_mapping", "param": {
                "node": checker, "scale": [2.0, 3.0, 1.0],
                "rotation": [0.0, 0.0, 30.0], "location": [0.1, 0.0, 0.0]}},
            "bump": {"fn": asset("bumps.png"), "color_space": "linear"},
            "bump_scale": 1.0}},
        {"type": "diffuse", "name": "Fresnel", "param": {"color": {
            "type": "mix", "param": {
                "t": {"type": "fresnel", "param": {"ior": 1.5}},
                "A": [0.7, 0.15, 0.1], "B": [0.1, 0.3, 0.85]}}}},
    ]
    s["shapes"][0]["param"]["material"] = "Checker"   # floor
    s["shapes"][2]["param"]["material"] = "Checker"   # back wall
    s["shapes"][5]["param"]["material"] = "Fresnel"   # short box
    s["shapes"][6]["param"]["material"] = "Mapped"    # tall box
    s["shapes"][7]["param"]["emission"]["param"].update(
        color={"fn": asset("checker.png"), "color_space": "srgb"}, scale=40.0)
    s["light_sampler"] = {"type": "uniform", "param": {"lights": [
        {"type": "spot", "param": {
            "color": [3.0, 2.8, 2.4], "scale": 1.0,
            "position": [0.55, 1.95, 0.35], "direction": [-0.2, -1.0, 0.1],
            "angle": 70.0, "falloff": 10.0, "ies": asset("spot.ies")}}]}}
    return s


# row-vector form: the sky's +z pole to world +y (as `cbox_sky`)
SKY_O2W = {"type": "matrix4x4", "param": {"matrix4x4": [
    [1, 0, 0, 0], [0, 0, -1, 0], [0, 1, 0, 0], [0, 0, 0, 1]]}}


def env_sphere(res=512, sub_div=40):
    """A checkered sphere on a ground quad under the `mix` of two skies
    and a projector casting an RGBA image."""
    s = _base(res)
    s["materials"] = [
        {"type": "diffuse", "name": "Checker", "param": {
            "color": {"fn": asset("checker.png"), "color_space": "srgb"}}},
        {"type": "diffuse", "name": "Ground", "param": {
            "color": [0.5, 0.5, 0.5]}},
    ]
    s["shapes"] = [
        {"type": "sphere", "name": "ball", "param": {
            "radius": 1.0, "sub_div": sub_div, "material": "Checker",
            "transform": {"type": "matrix4x4", "param": {"matrix4x4": [
                [1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]]}}}},
        {"type": "quad", "name": "ground", "param": {
            "width": 8.0, "height": 8.0, "material": "Ground",
            "transform": {"type": "matrix4x4", "param": {"matrix4x4": [
                [1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0], [0, -1, 0, 1]]}}}},
    ]
    s["camera"]["param"]["fov_y"] = 35.0
    s["camera"]["param"]["transform"] = {"type": "look_at", "param": {
        "position": [0.0, 0.8, 4.5], "up": [0, 1, 0],
        "target_pos": [0.0, -0.1, 0.0]}}

    def env(fn):
        return {"type": "spherical", "param": {
            "color": {"fn": asset(fn), "color_space": "linear"},
            "o2w": copy.deepcopy(SKY_O2W)}}

    s["light_sampler"] = {"type": "uniform", "param": {"lights": [
        {"type": "mix", "param": {"env0": env("sky_a.hdr"), "scale0": 0.7,
                                  "env1": env("sky_b.hdr"), "scale1": 0.5}},
        {"type": "projector", "param": {
            "color": {"fn": asset("projector.png"), "color_space": "srgb"},
            "scale": 40.0, "angle": 22.0, "ratio": 2.0,
            "o2w": {"type": "look_at", "param": {
                "position": [2.2, 2.6, 2.0], "target_pos": [0.0, -0.3, 0.0],
                "up": [0, 1, 0]}}}},
    ]}}
    return s


def lf_cbox(res=512, grid=3):
    """The cbox through a thin lens under the light-field frame buffer."""
    s = _base(res)
    s["camera"]["param"]["lens_radius"] = 0.35
    s["camera"]["param"]["focal_distance"] = 6.0
    s["pipeline"] = {"param": {"frame_buffer": {"type": "light_field",
                                                "param": {"grid": grid}}}}
    return s


def wall_texture():
    """The 8x8 texture of `tests/test_diff.py`'s textured cbox."""
    import numpy as np
    return (np.random.RandomState(7).rand(8, 8, 3) * 0.8 + 0.1).astype(
        np.float32)


def tex_wall_cbox(res, png_path):
    """The cbox whose back wall is a diffuse material with the image at
    `png_path` (srgb), as `tests/test_diff.py` builds it; the caller writes
    `wall_texture()` there."""
    s = _base(res)
    s["materials"] = list(s["materials"]) + [{
        "type": "diffuse", "name": "texwall",
        "param": {"color": {"fn": png_path, "color_space": "srgb"}}}]
    for sh in s["shapes"]:
        if sh.get("name") == "back":
            sh["param"]["material"] = "texwall"
            break
    return s
