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

  * mesh files (slice 7): `cbox_sphere_files` writes `cbox_sphere`'s
    sphere as OBJ, PLY, GLB and STL (`write_obj`, `write_ply`,
    `write_glb`, `write_stl`) and returns the scene on each as a `model`
    shape; `cbox_spheres_instanced_obj` places one OBJ 16 times;
    `gltf_cbox` writes the cbox as a GLB (`GltfBuilder`: materials, a
    JPEG floor, a gold sphere, an emissive and a point light, a camera
    node; 996 triangles, K1) and `gltf_cbox_scene` imports it at a given
    resolution and depth 8.

The images and the IES profile are the files of `tests/assets_torch/`
(`tools/gen_torch_assets.py` writes them; `gen_assets` is that module,
for its encoders); the scenes name them by absolute path.

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

# the asset generator (its PNG, TGA and BMP encoders), loaded by path
_spec = importlib.util.spec_from_file_location(
    "vt_gen_torch_assets", os.path.join(os.path.dirname(ASSETS), "..",
                                        "tools", "gen_torch_assets.py"))
gen_assets = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(gen_assets)
# its WebP writers (tools/gen_torch_webp.py)
gen_webp = gen_assets._webp_module()
# the encoders of slices 7e.6a's and 7e.6b's formats (tools/gen_torch_pil.py)
gen_pil = gen_assets._pil_module()
# slice 7e.4's TIFF encoders and files (tools/gen_torch_tiff.py)
gen_tiff = gen_assets._tiff_module()


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


def _swap_files(desc, twins):
    """`desc` with each image path whose file name is a key of `twins`
    replaced by the twin file's path (tests/assets_torch)."""
    if isinstance(desc, dict):
        return {k: (asset(twins[os.path.basename(v)]) if k in ("fn", "ies")
                    and isinstance(v, str) and os.path.basename(v) in twins
                    else _swap_files(v, twins)) for k, v in desc.items()}
    if isinstance(desc, list):
        return [_swap_files(v, twins) for v in desc]
    return desc


# slice 7d: each PNG / .hdr of the textured scenes and its twin in another
# format, written by tools/gen_torch_assets.py / gen_torch_exr.py with the
# same pixels
CBOX_TEX_TWINS = {"checker.png": "checker_lzw.tif", "bumps.png": "bumps.gif"}
ENV_SPHERE_TWINS = {"sky_a.hdr": "sky_a.exr", "sky_b.hdr": "sky_b.exr",
                    "checker.png": "checker_lzw.tif",
                    "projector.png": "projector.gif"}


def cbox_tex_files(res=512):
    """`cbox_tex` with its images read from TIFF (LZW, predictor 2) and
    GIF files of the same pixels: it renders as `cbox_tex` does."""
    return _swap_files(cbox_tex(res), CBOX_TEX_TWINS)


def env_sphere_files(res=512, sub_div=40):
    """`env_sphere` with its skies read from OpenEXR files (FLOAT; PIZ
    scanlines, RLE mip-mapped tiles), its checker from an LZW TIFF and its
    projector image from a GIF, each of the same pixels as the original:
    it renders as `env_sphere` does."""
    return _swap_files(env_sphere(res, sub_div), ENV_SPHERE_TWINS)


# slice 7e.1: WebP twins, written by tools/gen_torch_webp.py. The lossy
# checker decodes to other pixels, so its scene is held against `cbox_tex`
# reading PIL's decode of it (checker_lossy_pil.png); the lossless files
# hold the PNGs' pixels.
CBOX_TEX_WEBP = {"checker.png": "checker_lossy.webp", "bumps.png": "bumps.webp"}
CBOX_TEX_WEBP_REF = {"checker.png": "checker_lossy_pil.png"}
ENV_SPHERE_WEBP = {"checker.png": "checker.webp",
                   "projector.png": "projector.webp"}


def cbox_tex_webp(res=512):
    """`cbox_tex` with its checker from a lossy WebP file (VP8, quality 80)
    and its normal map from a lossless one (VP8L): it renders as
    `cbox_tex_webp_ref` does."""
    return _swap_files(cbox_tex(res), CBOX_TEX_WEBP)


def cbox_tex_webp_ref(res=512):
    """`cbox_tex` with its checker read from PIL's decode of
    checker_lossy.webp, written as a PNG."""
    return _swap_files(cbox_tex(res), CBOX_TEX_WEBP_REF)


def env_sphere_webp(res=512, sub_div=40):
    """`env_sphere` with its checker from a lossless WebP file and its
    projector image from a lossless WebP file with alpha in a VP8X
    container: it renders as `env_sphere` does."""
    return _swap_files(env_sphere(res, sub_div), ENV_SPHERE_WEBP)


# slices 7e.2 and 7e.3a: files OpenCV decodes with its own code, written by
# tools/gen_torch_exr.py. The luminance-chroma sky decodes through OpenCV's
# chroma conversion, so its scene is held against one reading OpenCV's
# decode of it from a plain FLOAT OpenEXR file (sky_yc_ref.exr); the PFM
# and deep files hold the .hdr skies' own decodes.
ENV_SPHERE_CV = {"sky_a.hdr": "sky_a_pfm.hdr", "sky_b.hdr": "sky_b_deep.exr"}


def _cbox_sky_file(res, fn, scale=None):
    s = cbox_sky(res)
    light = s["light_sampler"]["param"]["lights"][0]["param"]
    light["color"]["fn"] = asset(fn)
    if scale is not None:
        light["scale"] = scale
    return s


def cbox_sky_yc(res=512):
    """`cbox_sky` lit by a luminance-chroma OpenEXR sky (RgbaOutputFile's
    Y, RY, BY, PIZ) instead of its missing one: it renders as
    `cbox_sky_yc_ref` does."""
    return _cbox_sky_file(res, "sky_yc.exr")


def cbox_sky_yc_ref(res=512):
    """`cbox_sky` lit by OpenCV 4.6.0's decode of sky_yc.exr, written as an
    uncompressed FLOAT OpenEXR file."""
    return _cbox_sky_file(res, "sky_yc_ref.exr")


def env_sphere_cv(res=512, sub_div=40):
    """`env_sphere` with its skies from a PFM file named .hdr (OpenCV's
    PFM reader) and from a deep scanline OpenEXR file with Z and A (1-3
    samples a pixel, composited): it renders as `env_sphere` does."""
    return _swap_files(env_sphere(res, sub_div), ENV_SPHERE_CV)


# slice 7e.6a: twins in the small formats PIL opens, written by
# tools/gen_torch_pil.py. The QOI, PPM, run-length SGI and icon files hold
# the PNGs' pixels; the BC7 checker decodes to other pixels, so its scene
# is held against `cbox_tex` reading PIL's decode of it
# (checker_bc7_pil.png).
CBOX_TEX_PIL = {"checker.png": "checker.qoi", "bumps.png": "bumps.ppm"}
ENV_SPHERE_PIL = {"checker.png": "checker_rle.sgi",
                  "projector.png": "projector_bmp.ico"}
CBOX_TEX_DDS = {"checker.png": "checker_bc7.dds"}
CBOX_TEX_DDS_REF = {"checker.png": "checker_bc7_pil.png"}


def cbox_tex_pil(res=512):
    """`cbox_tex` with its checker from a QOI file and its normal map from
    a binary PPM (P6): it renders as `cbox_tex` does."""
    return _swap_files(cbox_tex(res), CBOX_TEX_PIL)


def env_sphere_pil(res=512, sub_div=40):
    """`env_sphere` with its checker from a run-length SGI file and its
    projector image from an icon holding a 32-bit BMP: it renders as
    `env_sphere` does."""
    return _swap_files(env_sphere(res, sub_div), ENV_SPHERE_PIL)


def cbox_tex_dds(res=512):
    """`cbox_tex` with its checker from a BC7 DDS file: it renders as
    `cbox_tex_dds_ref` does."""
    return _swap_files(cbox_tex(res), CBOX_TEX_DDS)


def cbox_tex_dds_ref(res=512):
    """`cbox_tex` with its checker read from PIL's decode of
    checker_bc7.dds, written as a PNG."""
    return _swap_files(cbox_tex(res), CBOX_TEX_DDS_REF)


# slice 7e.6b: twins in the rarer formats PIL opens, written by
# tools/gen_torch_pil.py; each holds the PNG's pixels (the checker's two
# colours in a palette).
CBOX_TEX_RARE = {"checker.png": "checker.blp", "bumps.png": "bumps.gbr"}
ENV_SPHERE_RARE = {"checker.png": "checker.flc",
                   "projector.png": "projector.pxr"}


def cbox_tex_rare(res=512):
    """`cbox_tex` with its checker from a BLP2 palette file and its normal
    map from a GIMP brush (version 2, RGBA): it renders as `cbox_tex`
    does."""
    return _swap_files(cbox_tex(res), CBOX_TEX_RARE)


def env_sphere_rare(res=512, sub_div=40):
    """`env_sphere` with its checker from an FLC animation (a colour chunk
    and a BRUN frame) and its projector image from a PIXAR raster: it
    renders as `env_sphere` does."""
    return _swap_files(env_sphere(res, sub_div), ENV_SPHERE_RARE)


# slice 7e.3b: TIFF and GIF files under .hdr / .exr names, read through
# OpenCV's own readers (tools/gen_torch_cvtiff.py). The float TIFF holds
# sky_a's floats; each scene is held against one reading the pip cv2's
# decode of its file from a FLOAT OpenEXR file or a PFM named .hdr. Under
# a .hdr name the GIF's samples come as 0-255 with no /255, so the
# projector's scale is divided by 255.
def cbox_sky_cvtiff(res=512):
    """`cbox_sky` lit by sky_a as a float32 TIFF (LZW, floating-point
    predictor) named .exr: it renders as `cbox_sky_cvtiff_ref` does."""
    return _cbox_sky_file(res, "sky_a_f32.exr")


def cbox_sky_cvtiff_ref(res=512):
    """`cbox_sky` lit by the pip cv2's decode of sky_a_f32.exr, written as
    an uncompressed FLOAT OpenEXR file."""
    return _cbox_sky_file(res, "sky_a_f32_ref.exr")


def _env_sphere_projector(res, sub_div, fn, scale=40.0 / 255.0):
    s = env_sphere(res, sub_div)
    proj = s["light_sampler"]["param"]["lights"][1]["param"]
    proj["color"]["fn"] = asset(fn)
    proj["scale"] = scale
    return s


def env_sphere_cvgif(res=512, sub_div=40):
    """`env_sphere` with its projector image from a GIF named .hdr (0-255
    samples, the projector's scale divided by 255): it renders as
    `env_sphere_cvgif_ref` does."""
    return _env_sphere_projector(res, sub_div, "projector_gif.hdr")


def env_sphere_cvgif_ref(res=512, sub_div=40):
    """`env_sphere_cvgif` with the pip cv2's decode of its GIF read from a
    PFM file named .hdr."""
    return _env_sphere_projector(res, sub_div, "projector_gif_pfm.hdr")


# slice 7e.4: the rarer TIFF codecs and layouts (tools/gen_torch_tiff.py).
# The BigTIFF holds sky_a's floats, so its scene is held against the one
# reading the pip cv2's decode of sky_a_f32.exr; the ZSTD TIFF holds the
# projector PNG's RGB, which is all PIL's convert("RGB") keeps of it.
ENV_SPHERE_ZSTD = {"projector.png": "projector_zstd.tif"}


def cbox_sky_bigtiff(res=512):
    """`cbox_sky` lit by sky_a as a float32 BigTIFF (Deflate, the
    floating-point predictor) named .exr: it renders as
    `cbox_sky_cvtiff_ref` does."""
    return _cbox_sky_file(res, "sky_a_big.exr")


def env_sphere_zstd(res=512, sub_div=40):
    """`env_sphere` with its projector image from an RGB ZSTD TIFF (the
    horizontal predictor) on PIL's route: it renders as `env_sphere`
    does."""
    return _swap_files(env_sphere(res, sub_div), ENV_SPHERE_ZSTD)


# slice 7e.5 (tools/gen_torch_assets.py `jpeg_7e5_files`): the checker as a
# progressive JPEG cut inside a scan, decoded through libjpeg's block
# smoothing, and the projector's RGB as a 4:2:0 lossless JPEG; each decodes
# to other pixels than its PNG, so its scene is held against one reading
# PIL's decode of the file from a PNG.
CBOX_TEX_SMOOTH = {"checker.png": "checker_smooth.jpg"}
CBOX_TEX_SMOOTH_REF = {"checker.png": "checker_smooth_pil.png"}
ENV_SPHERE_LOSSLESS = {"projector.png": "projector_lossless.jpg"}
ENV_SPHERE_LOSSLESS_REF = {"projector.png": "projector_lossless_pil.png"}


def cbox_tex_smooth(res=512):
    """`cbox_tex` with its checker from a progressive JPEG cut inside its
    third scan: it renders as `cbox_tex_smooth_ref` does."""
    return _swap_files(cbox_tex(res), CBOX_TEX_SMOOTH)


def cbox_tex_smooth_ref(res=512):
    """`cbox_tex` with its checker read from PIL's decode of
    checker_smooth.jpg, written as a PNG."""
    return _swap_files(cbox_tex(res), CBOX_TEX_SMOOTH_REF)


def env_sphere_lossless(res=512, sub_div=40):
    """`env_sphere` with its projector image from a lossless JPEG, 4:2:0
    (the first component 2x2): it renders as `env_sphere_lossless_ref`
    does."""
    return _swap_files(env_sphere(res, sub_div), ENV_SPHERE_LOSSLESS)


def env_sphere_lossless_ref(res=512, sub_div=40):
    """`env_sphere` with its projector image read from PIL's decode of
    projector_lossless.jpg, written as a PNG."""
    return _swap_files(env_sphere(res, sub_div), ENV_SPHERE_LOSSLESS_REF)


# slice 7e.4b (tools/gen_torch_ojpeg.py): the checker as an interchange
# old-style JPEG TIFF (4:2:0), and the projector's RGB as a tables-only one
# (4:2:0, a strip and a restart interval each MCU row); each decodes to
# other pixels than its PNG, so its scene is held against one reading PIL's
# decode of the file from a PNG.
CBOX_TEX_OJPEG = {"checker.png": "checker_ojpeg.tif"}
CBOX_TEX_OJPEG_REF = {"checker.png": "checker_ojpeg_pil.png"}
ENV_SPHERE_OJPEG = {"projector.png": "projector_ojpeg.tif"}
ENV_SPHERE_OJPEG_REF = {"projector.png": "projector_ojpeg_pil.png"}


def cbox_tex_ojpeg(res=512):
    """`cbox_tex` with its checker from an old-style JPEG TIFF: it renders
    as `cbox_tex_ojpeg_ref` does."""
    return _swap_files(cbox_tex(res), CBOX_TEX_OJPEG)


def cbox_tex_ojpeg_ref(res=512):
    """`cbox_tex` with its checker read from PIL's decode of
    checker_ojpeg.tif, written as a PNG."""
    return _swap_files(cbox_tex(res), CBOX_TEX_OJPEG_REF)


def env_sphere_ojpeg(res=512, sub_div=40):
    """`env_sphere` with its projector image from a tables-only old-style
    JPEG TIFF of several strips: it renders as `env_sphere_ojpeg_ref`
    does."""
    return _swap_files(env_sphere(res, sub_div), ENV_SPHERE_OJPEG)


def env_sphere_ojpeg_ref(res=512, sub_div=40):
    """`env_sphere` with its projector image read from PIL's decode of
    projector_ojpeg.tif, written as a PNG."""
    return _swap_files(env_sphere(res, sub_div), ENV_SPHERE_OJPEG_REF)


# slice 7e.7a (tools/gen_torch_j2k.py): the checker as a lossy JP2 file
# (9/7, ICT, two quality layers), and the projector's RGB as a reversible
# J2K codestream (5/3, RCT, four tiles with a tile offset, PCRL,
# precincts); the lossy one decodes to other pixels than its PNG, so each
# scene is held against one reading PIL's decode of its file from a PNG.
CBOX_TEX_J2K = {"checker.png": "checker_j2k.jp2"}
CBOX_TEX_J2K_REF = {"checker.png": "checker_j2k_pil.png"}
ENV_SPHERE_J2K = {"projector.png": "projector_j2k.j2k"}
ENV_SPHERE_J2K_REF = {"projector.png": "projector_j2k_pil.png"}


def cbox_tex_j2k(res=512):
    """`cbox_tex` with its checker from a lossy JP2 file: it renders as
    `cbox_tex_j2k_ref` does."""
    return _swap_files(cbox_tex(res), CBOX_TEX_J2K)


def cbox_tex_j2k_ref(res=512):
    """`cbox_tex` with its checker read from PIL's decode of
    checker_j2k.jp2, written as a PNG."""
    return _swap_files(cbox_tex(res), CBOX_TEX_J2K_REF)


def env_sphere_j2k(res=512, sub_div=40):
    """`env_sphere` with its projector image from a tiled reversible J2K
    codestream: it renders as `env_sphere_j2k_ref` does."""
    return _swap_files(env_sphere(res, sub_div), ENV_SPHERE_J2K)


def env_sphere_j2k_ref(res=512, sub_div=40):
    """`env_sphere` with its projector image read from PIL's decode of
    projector_j2k.j2k, written as a PNG."""
    return _swap_files(env_sphere(res, sub_div), ENV_SPHERE_J2K_REF)


# slice 7e.4b on OpenCV's route (tools/gen_torch_sgilog.py): sky_a as a
# LogLuv32 TIFF named .exr, and the projector's RGB / 255 as a LogLuv24
# TIFF named .hdr (LogLuv24 holds luminances up to 15.7, so its samples
# stay in 0-1 and the projector keeps its scale of 40). Each decodes to
# other floats than its source, so its scene is held against one reading
# the pip cv2's decode of its file from a FLOAT OpenEXR file or a PFM
# named .hdr.
def cbox_sky_logluv(res=512):
    """`cbox_sky` lit by sky_a as a LogLuv32 TIFF (SGILog run-length
    coded, strips of 5 rows) named .exr: it renders as
    `cbox_sky_logluv_ref` does."""
    return _cbox_sky_file(res, "sky_a_logluv.exr")


def cbox_sky_logluv_ref(res=512):
    """`cbox_sky` lit by the pip cv2's decode of sky_a_logluv.exr, written
    as an uncompressed FLOAT OpenEXR file."""
    return _cbox_sky_file(res, "sky_a_logluv_ref.exr")


def env_sphere_luv24(res=512, sub_div=40):
    """`env_sphere` with its projector image from a LogLuv24 TIFF named
    .hdr (the projector's RGB / 255): it renders as `env_sphere_luv24_ref`
    does."""
    return _env_sphere_projector(res, sub_div, "projector_luv24.hdr", 40.0)


def env_sphere_luv24_ref(res=512, sub_div=40):
    """`env_sphere_luv24` with the pip cv2's decode of its LogLuv24 file
    read from a PFM file named .hdr."""
    return _env_sphere_projector(res, sub_div, "projector_luv24_pfm.hdr",
                                 40.0)


# slice 7e.7b (tools/gen_torch_j2k_cv.py): sky_a times 1600, rounded, as a
# lossless 5/3 16-bit RGB JP2 named .exr (OpenCV keeps its 16-bit samples,
# so the sky's scale of 3 is divided by 1600), and the projector's RGB as
# an 8-bit 9/7 JP2 named .hdr (0-255 samples: the projector's scale
# divided by 255). Each scene is held against one reading the pip cv2's
# decode of its file from a FLOAT OpenEXR file or a PFM named .hdr.
SKY_J2KCV_SCALE = 3.0 / 1600


def cbox_sky_j2kcv(res=512):
    """`cbox_sky` lit by sky_a as a lossless 16-bit JP2 named .exr: it
    renders as `cbox_sky_j2kcv_ref` does."""
    return _cbox_sky_file(res, "sky_a_j2kcv.exr", SKY_J2KCV_SCALE)


def cbox_sky_j2kcv_ref(res=512):
    """`cbox_sky_j2kcv` lit by the pip cv2's decode of sky_a_j2kcv.exr,
    written as an uncompressed FLOAT OpenEXR file."""
    return _cbox_sky_file(res, "sky_a_j2kcv_ref.exr", SKY_J2KCV_SCALE)


def env_sphere_j2kcv(res=512, sub_div=40):
    """`env_sphere` with its projector image from a 9/7 JP2 named .hdr
    (0-255 samples, the projector's scale divided by 255): it renders as
    `env_sphere_j2kcv_ref` does."""
    return _env_sphere_projector(res, sub_div, "projector_j2kcv.hdr")


def env_sphere_j2kcv_ref(res=512, sub_div=40):
    """`env_sphere_j2kcv` with the pip cv2's decode of its JP2 file read
    from a PFM file named .hdr."""
    return _env_sphere_projector(res, sub_div, "projector_j2kcv_pfm.hdr")


# slice 7e.7d (tools/gen_torch_j2k_p2.py): the checker as a JP2 whose CBD
# gives 9-bit samples and whose main header's MCO sets offsets, read on
# PIL's route; the projector's RGB as four tiles with different MCOs in
# their tile-part headers, named .exr (OpenCV's route, 0-255 samples).
# Each scene is held against one reading the library's decode of its file
# from a PNG or a PFM named .hdr.
CBOX_TEX_J2KP2 = {"checker.png": "checker_j2kp2.jp2"}
CBOX_TEX_J2KP2_REF = {"checker.png": "checker_j2kp2_pil.png"}


def cbox_tex_j2kp2(res=512):
    """`cbox_tex` with its checker from a JP2 of Part 2's CBD and MCO: it
    renders as `cbox_tex_j2kp2_ref` does."""
    return _swap_files(cbox_tex(res), CBOX_TEX_J2KP2)


def cbox_tex_j2kp2_ref(res=512):
    """`cbox_tex` with its checker read from PIL's decode of
    checker_j2kp2.jp2, written as a PNG."""
    return _swap_files(cbox_tex(res), CBOX_TEX_J2KP2_REF)


def env_sphere_j2kp2cv(res=512, sub_div=40):
    """`env_sphere` with its projector image from a tiled codestream named
    .exr whose tiles carry different MCOs: it renders as
    `env_sphere_j2kp2cv_ref` does."""
    return _env_sphere_projector(res, sub_div, "projector_j2kp2cv.exr")


def env_sphere_j2kp2cv_ref(res=512, sub_div=40):
    """`env_sphere_j2kp2cv` with the pip cv2's decode of its file read
    from a PFM file named .hdr."""
    return _env_sphere_projector(res, sub_div, "projector_j2kp2cv_pfm.hdr")


# slice 7e.7c (tools/gen_torch_j2k_ht.py): the checker as a reversible HTJ2K
# JP2 (its cleanup passes hold every bit, so it decodes to the checker) on
# PIL's route, held against `cbox_tex` itself; the projector's RGB as a 9/7
# HTJ2K codestream whose second layer refines its blocks (SigProp and
# MagRef), named .exr (OpenCV's route, 0-255 samples), held against one
# reading the pip cv2's decode of it from a PFM named .hdr.
CBOX_TEX_HTJ2K = {"checker.png": "checker_htj2k.jp2"}


def cbox_tex_htj2k(res=512):
    """`cbox_tex` with its checker from a reversible HTJ2K JP2: it renders
    as `cbox_tex` does."""
    return _swap_files(cbox_tex(res), CBOX_TEX_HTJ2K)


def env_sphere_htj2kcv(res=512, sub_div=40):
    """`env_sphere` with its projector image from a 9/7 HTJ2K codestream
    named .exr, refined in a second layer: it renders as
    `env_sphere_htj2kcv_ref` does."""
    return _env_sphere_projector(res, sub_div, "projector_htj2kcv.exr")


def env_sphere_htj2kcv_ref(res=512, sub_div=40):
    """`env_sphere_htj2kcv` with the pip cv2's decode of its file read
    from a PFM file named .hdr."""
    return _env_sphere_projector(res, sub_div, "projector_htj2kcv_pfm.hdr")


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


# ---------------------------------------------------------------------------
# Mesh files and glTF scenes (slice 7), written from procedural geometry
# ---------------------------------------------------------------------------

def _shapes():
    from vision_tpu_torch.scene import shapes
    return shapes


def write_obj(path, mesh):
    """v / vt / vn at %.9g (float32 round-trips exactly), f i/i/i."""
    import numpy as np
    P, N, UV = mesh.positions, mesh.normals, mesh.uvs
    lines = ["# written by tests/torch_scenes.py"]
    lines += ["v %.9g %.9g %.9g" % tuple(p) for p in P.tolist()]
    lines += ["vt %.9g %.9g" % tuple(t) for t in UV.tolist()]
    lines += ["vn %.9g %.9g %.9g" % tuple(n) for n in N.tolist()]
    T = np.asarray(mesh.triangles, np.int64) + 1
    lines += ["f %d/%d/%d %d/%d/%d %d/%d/%d" % (a, a, a, b, b, b, c, c, c)
              for a, b, c in T.tolist()]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def write_ply(path, mesh):
    """binary_little_endian: vertex x y z nx ny nz s t (float), face
    `list uchar int vertex_indices`."""
    import numpy as np
    V, T = len(mesh.positions), len(mesh.triangles)
    head = ("ply\nformat binary_little_endian 1.0\n"
            "comment written by tests/torch_scenes.py\n"
            f"element vertex {V}\n"
            + "".join(f"property float {c}\n"
                      for c in ("x", "y", "z", "nx", "ny", "nz", "s", "t"))
            + f"element face {T}\nproperty list uchar int vertex_indices\n"
            "end_header\n")
    vert = np.concatenate([mesh.positions, mesh.normals, mesh.uvs], 1)
    face = np.zeros(T, np.dtype([("n", "u1"), ("i", "<i4", (3,))]))
    face["n"] = 3
    face["i"] = mesh.triangles
    with open(path, "wb") as f:
        f.write(head.encode() + vert.astype("<f4").tobytes() + face.tobytes())


def write_stl(path, mesh):
    """Binary STL: each triangle's unit normal and its three corners."""
    import numpy as np
    P, T = mesh.positions, mesh.triangles
    tri = P[T]  # [T, 3, 3]
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
    rec = np.zeros(len(T), np.dtype([("n", "<f4", (3,)), ("v", "<f4", (3, 3)),
                                     ("a", "<u2")]))
    rec["n"], rec["v"] = n, tri
    with open(path, "wb") as f:
        f.write(b"binary STL written by tests/torch_scenes.py".ljust(80, b" ")
                + len(T).to_bytes(4, "little") + rec.tobytes())


def gltf_normals(normals):
    """Normals to store in a glTF file so that the loaders' float64
    normalization (gltf.py) rounds back to exactly these float32 normals:
    each one that would move is scaled by the first factor in (1, 1.0004]
    that lands it (a stored length within 4e-4 of 1)."""
    import numpy as np

    def renorm(n):
        n = n.astype(np.float64)
        ln = np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
        return (n / ln).astype(np.float32)

    want = np.asarray(normals, np.float32)
    out = want.copy()
    left = np.nonzero((renorm(out) != want).any(-1) & (want != 0).any(-1))[0]
    for s in np.linspace(1.0, 1.0004, 4097)[1:]:
        if not len(left):
            break
        cand = (want[left].astype(np.float64) * s).astype(np.float32)
        ok = (renorm(cand) == want[left]).all(-1)
        out[left[ok]] = cand[ok]
        left = left[~ok]
    if len(left):
        raise ValueError(f"{len(left)} normals do not round-trip")
    return out


class GltfBuilder:
    """A small glTF 2.0 writer: accessors in one buffer, meshes, nodes,
    materials, images, a camera and KHR_lights_punctual lights; saved as
    .glb, as .gltf with an external .bin, or as .gltf with a data URI."""

    def __init__(self):
        self.doc = {"asset": {"version": "2.0",
                              "generator": "tests/torch_scenes.py"},
                    "scene": 0, "scenes": [{"nodes": []}], "nodes": [],
                    "meshes": [], "accessors": [], "bufferViews": []}
        self.bin = bytearray()

    def _view(self, data, stride=None):
        while len(self.bin) % 4:
            self.bin.append(0)
        bv = {"buffer": 0, "byteOffset": len(self.bin), "byteLength": len(data)}
        if stride:
            bv["byteStride"] = stride
        self.bin += data
        self.doc["bufferViews"].append(bv)
        return len(self.doc["bufferViews"]) - 1

    def accessor(self, arr, normalized=False):
        """A tightly packed accessor of arr [count, n] (or [count])."""
        import numpy as np
        arr = np.ascontiguousarray(arr)
        ctype = {np.dtype("float32"): 5126, np.dtype("uint32"): 5125,
                 np.dtype("uint16"): 5123, np.dtype("uint8"): 5121,
                 np.dtype("int16"): 5122, np.dtype("int8"): 5120}[arr.dtype]
        n = 1 if arr.ndim == 1 else arr.shape[1]
        acc = {"bufferView": self._view(arr.astype(arr.dtype.newbyteorder("<"))
                                        .tobytes()),
               "componentType": ctype, "count": int(arr.shape[0]),
               "type": {1: "SCALAR", 2: "VEC2", 3: "VEC3", 4: "VEC4"}[n]}
        if normalized:
            acc["normalized"] = True
        if ctype == 5126 and n == 3:
            acc["min"] = arr.min(0).tolist()
            acc["max"] = arr.max(0).tolist()
        self.doc["accessors"].append(acc)
        return len(self.doc["accessors"]) - 1

    def interleaved(self, arrays):
        """float32 arrays [count, n_i] in one strided buffer view; returns
        one accessor per array."""
        import numpy as np
        count = arrays[0].shape[0]
        rec = np.concatenate([np.asarray(a, "<f4") for a in arrays], 1)
        view = self._view(rec.tobytes(), stride=rec.shape[1] * 4)
        out, off = [], 0
        for a in arrays:
            self.doc["accessors"].append({
                "bufferView": view, "byteOffset": off, "componentType": 5126,
                "count": int(count),
                "type": {2: "VEC2", 3: "VEC3"}[a.shape[1]]})
            out.append(len(self.doc["accessors"]) - 1)
            off += a.shape[1] * 4
        return out

    def mesh(self, mesh, material=None, uv_normalized=None, index_type="uint32"):
        """A one-primitive mesh of a TriMesh (POSITION, NORMAL through
        `gltf_normals`, TEXCOORD_0, indices); `uv_normalized` = "uint8" /
        "uint16" stores the uvs as normalized integers."""
        import numpy as np
        attrs = {"POSITION": self.accessor(np.asarray(mesh.positions, np.float32)),
                 "NORMAL": self.accessor(gltf_normals(mesh.normals))}
        if uv_normalized:
            top = np.iinfo(uv_normalized).max
            attrs["TEXCOORD_0"] = self.accessor(
                np.round(np.clip(mesh.uvs, 0, 1) * top).astype(uv_normalized),
                normalized=True)
        else:
            attrs["TEXCOORD_0"] = self.accessor(np.asarray(mesh.uvs, np.float32))
        prim = {"attributes": attrs, "mode": 4, "indices": self.accessor(
            np.asarray(mesh.triangles).reshape(-1).astype(index_type))}
        if material is not None:
            prim["material"] = material
        self.doc["meshes"].append({"primitives": [prim]})
        return len(self.doc["meshes"]) - 1

    def node(self, parent=None, **fields):
        self.doc["nodes"].append(fields)
        i = len(self.doc["nodes"]) - 1
        if parent is None:
            self.doc["scenes"][0]["nodes"].append(i)
        else:
            self.doc["nodes"][parent].setdefault("children", []).append(i)
        return i

    def material(self, name, color, metallic=0.0, roughness=1.0,
                 texture_uri=None, emissive=None):
        d = {"name": name, "pbrMetallicRoughness": {
            "baseColorFactor": list(color) + [1.0],
            "metallicFactor": metallic, "roughnessFactor": roughness}}
        if texture_uri is not None:
            self.doc.setdefault("images", []).append({"uri": texture_uri})
            self.doc.setdefault("samplers", []).append({})
            self.doc.setdefault("textures", []).append({
                "source": len(self.doc["images"]) - 1,
                "sampler": len(self.doc["samplers"]) - 1})
            d["pbrMetallicRoughness"]["baseColorTexture"] = {
                "index": len(self.doc["textures"]) - 1}
        if emissive is not None:
            d["emissiveFactor"] = list(emissive)
        self.doc.setdefault("materials", []).append(d)
        return len(self.doc["materials"]) - 1

    def point_light(self, color, intensity, position):
        ext = self.doc.setdefault("extensions", {}).setdefault(
            "KHR_lights_punctual", {"lights": []})
        ext["lights"].append({"type": "point", "color": list(color),
                              "intensity": intensity})
        self.doc.setdefault("extensionsUsed", []).append("KHR_lights_punctual")
        return self.node(translation=list(position), extensions={
            "KHR_lights_punctual": {"light": len(ext["lights"]) - 1}})

    def camera(self, yfov, matrix):
        self.doc.setdefault("cameras", []).append({
            "type": "perspective", "perspective": {
                "yfov": yfov, "aspectRatio": 1.0, "znear": 0.01}})
        return self.node(camera=len(self.doc["cameras"]) - 1,
                         matrix=[float(v) for v in matrix])

    def _doc(self, uri):
        import copy
        doc = copy.deepcopy(self.doc)
        doc["buffers"] = [{"byteLength": len(self.bin)}]
        if uri is not None:
            doc["buffers"][0]["uri"] = uri
        return doc

    def save(self, path, kind=None):
        """`kind`: "glb" (by default for a .glb path), "bin" (.gltf with an
        external .bin beside it) or "data" (.gltf with a data URI)."""
        import base64
        import json
        import struct
        kind = kind or ("glb" if path.endswith(".glb") else "bin")
        if kind == "glb":
            js = json.dumps(self._doc(None)).encode()
            js += b" " * (-len(js) % 4)
            bn = bytes(self.bin) + b"\0" * (-len(self.bin) % 4)
            body = (struct.pack("<II", len(js), 0x4E4F534A) + js
                    + struct.pack("<II", len(bn), 0x004E4942) + bn)
            with open(path, "wb") as f:
                f.write(struct.pack("<III", 0x46546C67, 2, 12 + len(body)) + body)
            return path
        if kind == "bin":
            bin_name = os.path.splitext(os.path.basename(path))[0] + ".bin"
            with open(os.path.join(os.path.dirname(path), bin_name), "wb") as f:
                f.write(bytes(self.bin))
            doc = self._doc(bin_name)
        else:
            doc = self._doc("data:application/octet-stream;base64,"
                            + base64.b64encode(bytes(self.bin)).decode())
        with open(path, "w") as f:
            json.dump(doc, f)
        return path


def write_glb(path, mesh):
    """One mesh as a GLB: POSITION / NORMAL / TEXCOORD_0 float32 and
    uint32 indices, under one node with no transform."""
    g = GltfBuilder()
    g.node(mesh=g.mesh(mesh), name="mesh")
    return g.save(path)


MESH_FORMATS = ("obj", "ply", "glb", "stl")


def cbox_sphere_files(dirname, res=512, sub_div=256):
    """`cbox_sphere` with its procedural sphere written to `dirname` as
    sphere.obj / .ply / .glb / .stl: {format: the cbox_sphere scene whose
    sphere is a `model` shape on that file} (file paths are absolute)."""
    shapes = _shapes()
    mesh = shapes.make_sphere(0.3, sub_div)
    writers = {"obj": write_obj, "ply": write_ply, "glb": write_glb,
               "stl": write_stl}
    out = {}
    for fmt in MESH_FORMATS:
        path = os.path.join(os.path.abspath(dirname), f"sphere.{fmt}")
        writers[fmt](path, mesh)
        s = cbox_sphere(res, sub_div)
        sph = s["shapes"][-1]
        sph["type"] = "model"
        sph["param"] = {"fn": path, "material": sph["param"]["material"],
                        "transform": sph["param"]["transform"]}
        out[fmt] = s
    return out


def cbox_spheres_instanced_obj(dirname, res=512, sub_div=128, radius=0.12):
    """`cbox_spheres_instanced` with its sphere one OBJ file (scaled to
    `radius` in the file) placed 16 times."""
    shapes = _shapes()
    mesh = shapes.make_sphere(radius, sub_div)
    path = os.path.join(os.path.abspath(dirname), "sphere_inst.obj")
    write_obj(path, mesh)
    s = cbox_spheres_instanced(res, sub_div, radius)
    for sh in s["shapes"][-16:]:
        sh["type"] = "model"
        sh["param"] = {"fn": path, "material": sh["param"]["material"],
                       "transform": sh["param"]["transform"]}
    return s


GLTF_TEXTURE = "tiles.jpg"   # in tests/assets_torch/, copied beside the GLB
GLTF_SPHERE = dict(radius=0.3, sub_div=16, translation=[0.33, 0.9, 0.37],
                   rotation_y=0.5)


def gltf_cbox(dirname, sub_div=GLTF_SPHERE["sub_div"]):
    """The cbox as a GLB in `dirname` (returns its path): its walls,
    boxes and emitter as nodes over object-space quads and cubes (the
    cbox's matrices as node matrices, under one parent node), the diffuse
    materials as pbrMetallicRoughness (metallic 0, roughness 1), the floor
    textured with `tiles.jpg` (copied beside the file) times a base
    colour, a rough gold sphere (sub_div 16) placed by TRS, the ceiling
    emitter as emissiveFactor (17, 12, 4; the importer takes factors above
    1 as they are), a KHR_lights_punctual point light and the cbox camera
    as a glTF camera node. 996 triangles: the dense sweep (K1)."""
    import math
    import shutil
    import numpy as np
    from vision_tpu_torch.core import transform as xf
    shapes = _shapes()
    shutil.copyfile(asset(GLTF_TEXTURE), os.path.join(dirname, GLTF_TEXTURE))
    g = GltfBuilder()
    mats = {}
    for m in CBOX_JSON["materials"]:
        mats[m["name"]] = g.material(m["name"], m["param"]["color"])
    mats["Tiles"] = g.material("Tiles", [0.9, 0.85, 0.8],
                               texture_uri=GLTF_TEXTURE)
    mats["Light"] = g.material("Light", [0.0, 0.0, 0.0], emissive=[17, 12, 4])
    mats["Gold"] = g.material("Gold", [1.0, 0.78, 0.34], metallic=1.0,
                              roughness=0.35)
    quad, cube = shapes.make_quad(), shapes.make_cube()
    room = g.node(name="cbox", translation=[0.0, 0.0, 0.0])
    for sh in CBOX_JSON["shapes"]:
        name = sh["name"]
        mat = {"floor": "Tiles", "light": "Light"}.get(
            name, sh["param"]["material"])
        geo = cube if sh["type"] == "cube" else quad
        rows = sh["param"]["transform"]["param"]["matrix4x4"]
        # row-vector rows flattened = the column-major matrix of glTF
        g.node(parent=room, name=name, mesh=g.mesh(geo, mats[mat]),
               matrix=[float(v) for r in rows for v in r])
    sp = GLTF_SPHERE
    a = sp["rotation_y"] / 2.0
    g.node(name="sphere", mesh=g.mesh(shapes.make_sphere(1.0, sub_div),
                                      mats["Gold"]),
           translation=sp["translation"], scale=[sp["radius"]] * 3,
           rotation=[0.0, math.sin(a), 0.0, math.cos(a)])
    g.point_light([1.0, 0.9, 0.8], 683.0 * 0.6, [-0.45, 1.6, 0.6])
    cam = CBOX_JSON["camera"]["param"]
    c2w = np.asarray(xf.from_json(cam["transform"]), np.float64)
    # glTF cameras look down -z: the node is the vision frame turned 180
    # degrees about y (the importer turns it back)
    node = c2w @ np.diag([-1.0, 1.0, -1.0, 1.0])
    g.camera(math.radians(cam["fov_y"]), node.T.reshape(-1))
    return g.save(os.path.join(dirname, "gltf_cbox.glb"))


def gltf_cbox_scene(dirname, res=512, max_depth=8):
    """`gltf_cbox` written to `dirname` and imported (the port's
    `load_gltf_scene`, equal to the JAX package's), at res x res and
    `max_depth`: (scene dict, scene_dir)."""
    from vision_tpu_torch.scene.gltf import load_gltf_scene
    path = gltf_cbox(dirname)
    s = load_gltf_scene(path)
    s["camera"]["param"]["radiance_collector"]["param"]["resolution"] = [res, res]
    s["integrator"] = {"type": "pt", "param": {"max_depth": max_depth}}
    return s, os.path.dirname(path)
