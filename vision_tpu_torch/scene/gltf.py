"""glTF 2.0 import (.gltf JSON with data-URI or external buffers, .glb).

Counterpart of `vision_tpu/scene/gltf.py`, host-side numpy:

  * `load_gltf`: the triangle primitives (POSITION / NORMAL / TEXCOORD_0
    and indices) with their nodes' world transforms applied (in float64,
    cast to float32 once), the whole file or one (node, primitive);
  * `load_gltf_scene`: the whole file as a scene dict, equal to the JAX
    package's: pbrMetallicRoughness materials as principled_bsdf rows
    (base colour, metallic, roughness, base-colour texture, normal texture
    as `bump`), emissiveFactor as an area emission, KHR_lights_punctual
    nodes as point / spot / directional lights, the first camera node as
    the pinhole camera; one `model` shape per primitive.

One deliberate difference: an accessor flagged `normalized` (a TEXCOORD_0
of normalized UNSIGNED_BYTE or UNSIGNED_SHORT, as glTF 2.0 allows) is
divided by its type's maximum, as the specification says; the JAX package
takes the raw integers (ROADMAP C16).
"""
from __future__ import annotations

import base64
import json
import os
import struct

import numpy as np

from .shapes import TriMesh

_COMP_DTYPE = {5120: np.int8, 5121: np.uint8, 5122: np.int16,
               5123: np.uint16, 5125: np.uint32, 5126: np.float32}
_TYPE_SIZE = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


def _load_gltf_json(path):
    if path.endswith(".glb"):
        with open(path, "rb") as f:
            data = f.read()
        magic, version, length = struct.unpack_from("<III", data, 0)
        if magic != 0x46546C67:
            raise ValueError(f"not a GLB file: {path}")
        off = 12
        doc = None
        buffers = []
        while off < length:
            clen, ctype = struct.unpack_from("<II", data, off)
            off += 8
            chunk = data[off:off + clen]
            off += clen
            if ctype == 0x4E4F534A:  # JSON
                doc = json.loads(chunk)
            elif ctype == 0x004E4942:  # BIN
                buffers.append(chunk)
        return doc, buffers
    with open(path, "r") as f:
        return json.load(f), []


def _read_buffer(doc, bin_chunks, idx, base_dir):
    buf = doc["buffers"][idx]
    uri = buf.get("uri")
    if uri is None:
        return bin_chunks[idx]
    if uri.startswith("data:"):
        return base64.b64decode(uri.split(",", 1)[1])
    with open(os.path.join(base_dir, uri), "rb") as f:
        return f.read()


def _accessor(doc, buffers_cache, bin_chunks, base_dir, idx):
    """Accessor `idx` as a [count, components] array of its component
    type, or float32 when it is `normalized`."""
    acc = doc["accessors"][idx]
    bv = doc["bufferViews"][acc["bufferView"]]
    bidx = bv["buffer"]
    if bidx not in buffers_cache:
        buffers_cache[bidx] = _read_buffer(doc, bin_chunks, bidx, base_dir)
    raw = buffers_cache[bidx]
    dtype = _COMP_DTYPE[acc["componentType"]]
    ncomp = _TYPE_SIZE[acc["type"]]
    count = acc["count"]
    offset = bv.get("byteOffset", 0) + acc.get("byteOffset", 0)
    stride = bv.get("byteStride") or dtype().itemsize * ncomp
    if stride == dtype().itemsize * ncomp:
        arr = np.frombuffer(raw, dtype, count * ncomp, offset)
        arr = arr.reshape(count, ncomp).copy()
    else:  # interleaved: element i starts at offset + i * stride
        arr = np.ndarray((count, ncomp), dtype, raw, offset,
                         (stride, dtype().itemsize)).copy()
    if acc.get("normalized") and dtype != np.float32:
        top = float(np.iinfo(dtype).max)
        arr = np.maximum(arr.astype(np.float32) / np.float32(top),
                         np.float32(-1.0))
    return arr


def _node_matrix(node):
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float64).reshape(4, 4).T
    m = np.eye(4)
    if "scale" in node:
        m[:3, :3] *= np.asarray(node["scale"])
    if "rotation" in node:  # xyzw quaternion
        x, y, z, w = node["rotation"]
        R = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])
        m = np.block([[R @ m[:3, :3], np.zeros((3, 1))], [np.zeros((1, 3)), np.ones((1, 1))]])
    if "translation" in node:
        m[:3, 3] = node["translation"]
    return m


def _walk_nodes(doc):
    """Yield (node_idx, world_matrix) in scene order."""
    out = []

    def visit(node_idx, parent):
        node = doc["nodes"][node_idx]
        m = parent @ _node_matrix(node)
        out.append((node_idx, m))
        for c in node.get("children", []):
            visit(c, m)

    scene_idx = doc.get("scene", 0)
    roots = doc["scenes"][scene_idx]["nodes"] if "scenes" in doc else \
        list(range(len(doc.get("nodes", []))))
    for r in roots:
        visit(r, np.eye(4))
    return out


def load_gltf(path, node=None, prim=None):
    """The triangle primitives (mode 4), world-transformed, as one TriMesh;
    with `node` / `prim` given, only that node's / that primitive's."""
    doc, bin_chunks = _load_gltf_json(path)
    base_dir = os.path.dirname(os.path.abspath(path))
    cache = {}

    def acc(i):
        return _accessor(doc, cache, bin_chunks, base_dir, i)

    P, N, UV, T = [], [], [], []
    voff = 0
    for node_idx, m in _walk_nodes(doc):
        nd = doc["nodes"][node_idx]
        if (node is not None and node_idx != node) or "mesh" not in nd:
            continue
        for pi, pr in enumerate(doc["meshes"][nd["mesh"]].get("primitives", [])):
            if (prim is not None and pi != prim) or pr.get("mode", 4) != 4:
                continue
            attrs = pr["attributes"]
            pos = acc(attrs["POSITION"]).astype(np.float64)
            pos = pos @ m[:3, :3].T + m[:3, 3]
            n_el = len(pos)
            if "NORMAL" in attrs:
                nrm = acc(attrs["NORMAL"]).astype(np.float64)
                nrm = nrm @ np.linalg.inv(m[:3, :3])
                ln = np.linalg.norm(nrm, axis=-1, keepdims=True)
                nrm = nrm / np.maximum(ln, 1e-12)
            else:
                nrm = np.zeros_like(pos)
            if "TEXCOORD_0" in attrs:
                uv = acc(attrs["TEXCOORD_0"]).astype(np.float32)
            else:
                uv = np.zeros((n_el, 2), np.float32)
            if "indices" in pr:
                idx = acc(pr["indices"]).reshape(-1).astype(np.int64)
            else:
                idx = np.arange(n_el, dtype=np.int64)
            P.append(pos.astype(np.float32))
            N.append(nrm.astype(np.float32))
            UV.append(uv[:, :2])
            T.append((idx.reshape(-1, 3) + voff).astype(np.int32))
            voff += n_el
    if not P:
        raise ValueError(f"no triangle meshes in {path}")
    return TriMesh(np.concatenate(P), np.concatenate(N),
                   np.concatenate(UV), np.concatenate(T))


def _map_material(doc, mat_idx, base_dir):
    """pbrMetallicRoughness -> vision material desc (principled_bsdf)."""
    gm = doc["materials"][mat_idx]
    name = gm.get("name", f"gltf_mat_{mat_idx}")
    pbr = gm.get("pbrMetallicRoughness", {})
    base = pbr.get("baseColorFactor", [1.0, 1.0, 1.0, 1.0])
    param = {"metallic": float(pbr.get("metallicFactor", 1.0)),
             "roughness": float(pbr.get("roughnessFactor", 1.0))}
    tex = pbr.get("baseColorTexture")
    if tex is not None:
        src = doc["textures"][tex["index"]].get("source")
        uri = doc["images"][src].get("uri") if src is not None else None
        if uri and not uri.startswith("data:"):
            img = {"fn": uri, "color_space": "srgb"}
            if any(abs(b - 1.0) > 1e-6 for b in base[:3]):
                # glTF spec: baseColorFactor MULTIPLIES the texture; fold
                # through a shader-graph multiply node (bakes at load)
                param["color"] = {"type": "multiply",
                                  "param": {"lhs": img,
                                            "rhs": list(base[:3])}}
            else:
                param["color"] = img
        else:
            param["color"] = list(base[:3])
    else:
        param["color"] = list(base[:3])
    ntex = gm.get("normalTexture")
    if ntex is not None:
        src = doc["textures"][ntex["index"]].get("source")
        uri = doc["images"][src].get("uri") if src is not None else None
        if uri and not uri.startswith("data:"):
            param["bump"] = {"fn": uri, "color_space": "linear"}
            param["bump_scale"] = float(ntex.get("scale", 1.0))
    desc = {"type": "principled_bsdf", "name": name, "param": param}
    em = gm.get("emissiveFactor")
    emission = None
    if em and max(em) > 0:
        emission = {"type": "area",
                    "param": {"color": {"channels": "xyz", "node": list(em)},
                              "scale": 1.0}}
    return desc, emission


def load_gltf_scene(path):
    """Import a whole glTF file as a vision scene dict: per-primitive
    shapes bound to mapped materials, punctual lights, the first camera."""
    doc, _ = _load_gltf_json(path)
    base_dir = os.path.dirname(os.path.abspath(path))
    rel = os.path.basename(path)

    materials, emissions = [], {}
    for i in range(len(doc.get("materials", []))):
        desc, em = _map_material(doc, i, base_dir)
        materials.append(desc)
        if em is not None:
            emissions[desc["name"]] = em

    shapes = []
    lights = []
    camera = None
    ext_lights = doc.get("extensions", {}).get(
        "KHR_lights_punctual", {}).get("lights", [])
    for node_idx, m in _walk_nodes(doc):
        nd = doc["nodes"][node_idx]
        if "mesh" in nd:
            mesh = doc["meshes"][nd["mesh"]]
            for pi, pr in enumerate(mesh.get("primitives", [])):
                if pr.get("mode", 4) != 4:
                    continue
                param = {"fn": rel, "gltf_node": node_idx, "gltf_prim": pi}
                mi = pr.get("material")
                if mi is not None:
                    mname = materials[mi]["name"]
                    param["material"] = mname
                    if mname in emissions:
                        param["emission"] = emissions[mname]
                shapes.append({"type": "model",
                               "name": f"{nd.get('name', node_idx)}_{pi}",
                               "param": param})
        li = nd.get("extensions", {}).get("KHR_lights_punctual", {})
        if "light" in li and li["light"] < len(ext_lights):
            gl = ext_lights[li["light"]]
            # KHR_lights_punctual units are photometric (candela = lm/sr for
            # point/spot, lux for directional); the renderer works in
            # radiometric units. Convert via 683 lm/W luminous efficacy so
            # imported scenes land at a plausible radiance scale.
            intensity = gl.get("intensity", 1.0) / 683.0
            color = [c * intensity for c in gl.get("color", [1, 1, 1])]
            pos = list(map(float, m[:3, 3]))
            fwd = list(map(float, -m[:3, 2]))  # glTF lights point -z
            if gl.get("type") == "directional":
                lights.append({"type": "directional",
                               "param": {"color": color, "direction": fwd}})
            elif gl.get("type") == "spot":
                ang = np.rad2deg(gl.get("spot", {}).get(
                    "outerConeAngle", 0.785))
                lights.append({"type": "spot",
                               "param": {"color": color, "position": pos,
                                         "direction": fwd, "angle": ang}})
            else:
                lights.append({"type": "point",
                               "param": {"color": color, "position": pos}})
        if camera is None and "camera" in nd:
            gc = doc["cameras"][nd["camera"]]
            persp = gc.get("perspective", {})
            fov = np.rad2deg(persp.get("yfov", 0.7))
            # glTF cameras look down -z; vision's forward is the +z column.
            # Rotate 180 deg about y (keeps the frame right-handed).
            ry = np.diag([-1.0, 1.0, -1.0, 1.0])
            mv = np.asarray(m, np.float64) @ ry
            camera = {"type": "pinhole", "param": {
                "fov_y": float(fov),
                "transform": {"type": "matrix4x4", "param": {
                    "matrix4x4": mv.T.tolist()}},
                "radiance_collector": {"param": {"resolution": [512, 512]}},
            }}

    scene = {"materials": materials, "shapes": shapes}
    if lights:
        scene["light_sampler"] = {"type": "uniform",
                                  "param": {"lights": lights}}
    if camera is not None:
        scene["camera"] = camera
    return scene
