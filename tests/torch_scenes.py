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
