"""Procedural shapes and mesh files (host-side, numpy).

Counterpart of `vision_tpu/scene/shapes.py`: quad (XZ plane, +Y normal),
cube (24 verts / 12 tris with per-face normals), lat-long sphere, and the
`model` shape, a mesh file: Wavefront OBJ (the native parser of
`native.py`, as the JAX package takes it where its library loads; the
Python parser `load_obj` too), PLY (ascii and binary_little_endian), STL
(binary and ascii) and glTF / GLB (`gltf.py`). Two deliberate differences
from the JAX package: the STL weld keeps each cell's first vertex (the
JAX package's clamps negative coordinates to 0, ROADMAP C3), and a
binary PLY element is read property by property in the header's order
(the JAX package reads only the face list, C17).
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from .. import native
from ..core import transform as xf


@dataclass
class TriMesh:
    """Host mesh: positions [V,3], normals [V,3], uvs [V,2], tris [T,3] int32."""
    positions: np.ndarray
    normals: np.ndarray
    uvs: np.ndarray
    triangles: np.ndarray

    @property
    def num_triangles(self):
        return len(self.triangles)

    def transformed(self, m):
        return TriMesh(
            positions=xf.apply_points(m, self.positions).astype(np.float32),
            normals=xf.apply_normals(m, self.normals).astype(np.float32),
            uvs=self.uvs,
            triangles=self.triangles,
        )


def make_quad(width=1.0, height=1.0):
    """Quad in the XZ plane, +Y normal."""
    w, h = width / 2.0, height / 2.0
    P = np.array([[w, 0, h], [w, 0, -h], [-w, 0, h], [-w, 0, -h]], np.float32)
    N = np.tile(np.array([[0, 1, 0]], np.float32), (4, 1))
    UV = np.array([[1, 1], [1, 0], [0, 1], [0, 0]], np.float32)
    T = np.array([[0, 1, 2], [2, 1, 3]], np.int32)
    return TriMesh(P, N, UV, T)


def make_cube(x=1.0, y=None, z=None):
    """Axis-aligned box, 24 verts with per-face normals."""
    y = x if not y else y
    z = y if not z else z
    hx, hy, hz = x / 2.0, y / 2.0, z / 2.0
    P = np.array([
        [-hx, -hy, hz], [hx, -hy, hz], [-hx, hy, hz], [hx, hy, hz],      # +z
        [-hx, hy, -hz], [hx, hy, -hz], [-hx, -hy, -hz], [hx, -hy, -hz],  # -z
        [-hx, hy, hz], [hx, hy, hz], [-hx, hy, -hz], [hx, hy, -hz],      # +y
        [-hx, -hy, hz], [hx, -hy, hz], [-hx, -hy, -hz], [hx, -hy, -hz],  # -y
        [hx, -hy, hz], [hx, hy, hz], [hx, hy, -hz], [hx, -hy, -hz],      # +x
        [-hx, -hy, hz], [-hx, hy, hz], [-hx, hy, -hz], [-hx, -hy, -hz],  # -x
    ], np.float32)
    face_normals = np.array(
        [[0, 0, 1], [0, 0, -1], [0, 1, 0], [0, -1, 0], [1, 0, 0], [-1, 0, 0]],
        np.float32)
    N = np.repeat(face_normals, 4, axis=0)
    UV = np.array([
        [0, 0], [1, 0], [0, 1], [1, 1],
        [0, 1], [1, 1], [0, 0], [1, 0],
        [0, 1], [1, 1], [0, 0], [1, 0],
        [0, 1], [1, 1], [0, 0], [1, 0],
        [0, 1], [1, 1], [1, 0], [0, 0],
        [0, 1], [1, 1], [1, 0], [0, 0],
    ], np.float32)
    T = np.array([
        [0, 1, 3], [0, 3, 2],
        [6, 5, 7], [4, 5, 6],
        [10, 9, 11], [8, 9, 10],
        [13, 14, 15], [13, 12, 14],
        [18, 17, 19], [17, 16, 19],
        [21, 22, 23], [20, 21, 23],
    ], np.int32)
    return TriMesh(P, N, UV, T)


def make_sphere(radius=1.0, sub_div=60):
    """Lat-long sphere (the reference renderer's sphere topology)."""
    theta_div = int(sub_div)
    phi_div = 2 * theta_div
    verts = [np.array([0.0, radius, 0.0])]
    norms = [np.array([0.0, 1.0, 0.0])]
    uvs = [np.array([0.0, 0.0])]
    for i in range(1, theta_div):
        v = i / theta_div
        theta = np.pi * v
        yv = radius * np.cos(theta)
        r = radius * np.sin(theta)
        for j in range(phi_div):
            u = j / phi_div
            phi = u * 2.0 * np.pi
            p = np.array([np.cos(phi) * r, yv, np.sin(phi) * r])
            verts.append(p)
            norms.append(p / max(np.linalg.norm(p), 1e-20))
            uvs.append(np.array([u, v]))
    verts.append(np.array([0.0, -radius, 0.0]))
    norms.append(np.array([0.0, -1.0, 0.0]))
    uvs.append(np.array([0.0, 1.0]))

    tris = []
    for i in range(phi_div):
        tris.append([0, (i + 1) % phi_div + 1, i + 1])
    for i in range(theta_div - 2):
        vs = 1 + i * phi_div
        for j in range(phi_div):
            if j != phi_div - 1:
                tris.append([vs, vs + 1, vs + phi_div])
                tris.append([vs + 1, vs + phi_div + 1, vs + phi_div])
            else:
                tris.append([vs, vs + 1 - phi_div, vs + phi_div])
                tris.append([vs + 1 - phi_div, vs + 1, vs + phi_div])
            vs += 1
    ve = len(verts) - 1
    for i in range(phi_div):
        idx1 = i + 1
        idx2 = (1 + i) % phi_div + 1
        tris.append([ve, ve - idx2, ve - idx1])

    return TriMesh(np.asarray(verts, np.float32), np.asarray(norms, np.float32),
                   np.asarray(uvs, np.float32), np.asarray(tris, np.int32))


def _area_normals(P, T):
    """Area-weighted vertex normals."""
    p0, p1, p2 = P[T[:, 0]], P[T[:, 1]], P[T[:, 2]]
    fn = np.cross(p1 - p0, p2 - p0)
    N = np.zeros_like(P)
    for k in range(3):
        np.add.at(N, T[:, k], fn)
    N /= np.maximum(np.linalg.norm(N, axis=-1, keepdims=True), 1e-20)
    return N


def _no_normals(N):
    return not np.any(np.abs(N).sum(-1) > 0)


def load_obj(path, smooth=True):
    """Wavefront OBJ in Python (v / vn / vt / f, polygons fan-triangulated):
    one vertex per distinct face token ("1/2/3"), in the order of first
    use. Without normals (and `smooth`), area-weighted vertex normals."""
    vs, vts, vns = [], [], []
    out_pos, out_uv, out_nrm, tris = [], [], [], []
    cache = {}

    def emit(tok):
        if tok in cache:
            return cache[tok]
        parts = tok.split("/")
        vi = int(parts[0])
        vi = vi - 1 if vi > 0 else len(vs) + vi
        ti = ni = -1
        if len(parts) > 1 and parts[1]:
            ti = int(parts[1])
            ti = ti - 1 if ti > 0 else len(vts) + ti
        if len(parts) > 2 and parts[2]:
            ni = int(parts[2])
            ni = ni - 1 if ni > 0 else len(vns) + ni
        idx = len(out_pos)
        out_pos.append(vs[vi])
        out_uv.append(vts[ti] if ti >= 0 else (0.0, 0.0))
        out_nrm.append(vns[ni] if ni >= 0 else (0.0, 0.0, 0.0))
        cache[tok] = idx
        return idx

    with open(path, "r", errors="ignore") as f:
        for line in f:
            if line.startswith("v "):
                p = line.split()
                vs.append((float(p[1]), float(p[2]), float(p[3])))
            elif line.startswith("vt "):
                p = line.split()
                vts.append((float(p[1]), float(p[2])))
            elif line.startswith("vn "):
                p = line.split()
                vns.append((float(p[1]), float(p[2]), float(p[3])))
            elif line.startswith("f "):
                idxs = [emit(t) for t in line.split()[1:]]
                for k in range(1, len(idxs) - 1):
                    tris.append([idxs[0], idxs[k], idxs[k + 1]])

    P = np.asarray(out_pos, np.float32)
    N = np.asarray(out_nrm, np.float32)
    UV = np.asarray(out_uv, np.float32)
    T = np.asarray(tris, np.int32)
    if smooth and (len(N) == 0 or _no_normals(N)):
        N = _area_normals(P, T)
    return TriMesh(P, N, UV, T)


def load_model(path, smooth=True, gltf_node=None, gltf_prim=None):
    """A mesh file by its extension. OBJ goes through the native parser
    (`native.load_obj_native`), then area-weighted normals where the file
    has none, whatever `smooth` says (the JAX package's native route
    ignores it too); glTF / GLB through `gltf.load_gltf` (one node's one
    primitive when given); PLY; STL."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".obj":
        P, N, UV, T = native.load_obj_native(path)
        if len(T) and _no_normals(N):
            N = _area_normals(P, T)
        return TriMesh(P, N, UV, T)
    if ext in (".gltf", ".glb"):
        from .gltf import load_gltf
        return load_gltf(path, node=gltf_node, prim=gltf_prim)
    if ext == ".ply":
        return load_ply(path)
    if ext == ".stl":
        return load_stl(path)
    raise ValueError(f"unsupported mesh format: {ext}")


def load_stl(path):
    """STL (binary or ascii): a triangle soup welded by position (cells of
    1e-5) into an indexed mesh, each cell at its first vertex; degenerate
    faces of the weld dropped; area-weighted normals, zero uvs."""
    with open(path, "rb") as f:
        head = f.read(80)
        rest = f.read()
    is_ascii = head[:5].lower() == b"solid" and b"facet" in rest[:2048]
    if is_ascii:
        txt = (head + rest).decode("utf-8", errors="ignore")
        pts = []
        for line in txt.splitlines():
            t = line.strip().split()
            if len(t) >= 4 and t[0] == "vertex":
                pts.append([float(t[1]), float(t[2]), float(t[3])])
        verts = np.asarray(pts[:len(pts) // 3 * 3], np.float32).reshape(-1, 3)
    else:
        n = int.from_bytes(rest[:4], "little")
        data = np.frombuffer(rest[4:4 + n * 50], np.uint8)
        if len(data) < n * 50:
            raise ValueError("truncated binary STL")
        verts = data.reshape(n, 50)[:, 12:48].copy().view(np.float32).reshape(-1, 3)
    if len(verts) == 0:
        raise ValueError("empty STL")
    key = np.round(verts.astype(np.float64) * 1e5).astype(np.int64)
    _, first, inv = np.unique(key, axis=0, return_index=True,
                              return_inverse=True)
    P = verts[first]
    T = inv.reshape(-1, 3).astype(np.int64)
    T = T[(T[:, 0] != T[:, 1]) & (T[:, 1] != T[:, 2]) & (T[:, 0] != T[:, 2])]
    N = _area_normals(P, T)
    return TriMesh(P, N.astype(np.float32), np.zeros((len(P), 2), np.float32), T)


_PLY_DT = {"char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
           "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
           "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
           "float": "f4", "float32": "f4", "double": "f8", "float64": "f8"}


def _ply_header(f):
    """(format, [(element, count, [(name, dtype) | (name, count dtype,
    value dtype)])]) of an open PLY file, left at its data."""
    if f.readline().strip() != b"ply":
        raise ValueError(f"not a PLY file: {f.name}")
    fmt, elements = None, []
    while True:
        line = f.readline()
        if not line:
            raise ValueError("unterminated PLY header")
        parts = line.decode("ascii", "replace").strip().split()
        if not parts or parts[0] == "comment":
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if parts[1] == "list":
                elements[-1][2].append((parts[4], _PLY_DT[parts[2]],
                                        _PLY_DT[parts[3]]))
            else:
                elements[-1][2].append((parts[2], _PLY_DT[parts[1]]))
        elif parts[0] == "end_header":
            return fmt, elements


def _ply_binary_element(f, count, props):
    """One binary_little_endian element: {property: column}, a list
    property's column an int64 [count, n] array when every row's list has
    the first row's length, else a list of rows. Every property is read in
    the header's order."""
    if count == 0:
        return {p[0]: [] for p in props}
    pos, off, row = f.tell(), 0, []
    for p in props:  # the record layout, with the first row's list lengths
        if len(p) == 2:
            row.append((p[0], "<" + p[1]))
            off += np.dtype(p[1]).itemsize
            continue
        cdt, vdt = np.dtype("<" + p[1]), np.dtype("<" + p[2])
        f.seek(pos + off)
        b = f.read(cdt.itemsize)
        if len(b) < cdt.itemsize:
            raise ValueError("truncated PLY data")
        n = int(np.frombuffer(b, cdt)[0])
        row += [("#" + p[0], cdt), (p[0], vdt, (n,))]
        off += cdt.itemsize + n * vdt.itemsize
    dt = np.dtype(row)
    f.seek(pos)
    raw = f.read(dt.itemsize * count)
    if len(raw) == dt.itemsize * count:
        rec = np.frombuffer(raw, dt)
        lists = [p[0] for p in props if len(p) == 3]
        if all((rec["#" + k] == dt[k].shape[0]).all() for k in lists):
            return {p[0]: (rec[p[0]].astype(np.int64) if len(p) == 3
                           else rec[p[0]]) for p in props}
    f.seek(pos)  # lists of several lengths: row by row
    out = {p[0]: [] for p in props}
    for _ in range(count):
        for p in props:
            if len(p) == 2:
                dt = np.dtype("<" + p[1])
                out[p[0]].append(np.frombuffer(f.read(dt.itemsize), dt)[0])
            else:
                cdt, vdt = np.dtype("<" + p[1]), np.dtype("<" + p[2])
                n = int(np.frombuffer(f.read(cdt.itemsize), cdt)[0])
                out[p[0]].append(np.frombuffer(f.read(vdt.itemsize * n),
                                               vdt).tolist())
    return out


def _ply_ascii_element(f, count, props):
    """One ascii element: {property: column}, a list property's column a
    list of rows, every property read in the header's order (an element
    without lists as a float32 table first, as the JAX package reads it)."""
    rows = [f.readline().split() for _ in range(count)]
    if all(len(p) == 2 for p in props):
        arr = np.array([[float(v) for v in r] for r in rows],
                       np.float32).reshape(count, len(props))
        return {p[0]: arr[:, i] for i, p in enumerate(props)}
    out = {p[0]: [] for p in props}
    for r in rows:
        i = 0
        for p in props:
            if len(p) == 2:
                out[p[0]].append(float(r[i]))
                i += 1
            else:
                n = int(r[i])
                out[p[0]].append([int(v) for v in r[i + 1:i + 1 + n]])
                i += 1 + n
    return out


def _fan(faces):
    """Fan-triangulated faces ([F, n] array or a list of index rows) ->
    int32 [T, 3], face by face."""
    if isinstance(faces, np.ndarray):
        n = faces.shape[1]
        if n < 3:
            return np.zeros((0, 3), np.int32)
        return np.stack([faces[:, [0, k, k + 1]] for k in range(1, n - 1)],
                        1).reshape(-1, 3).astype(np.int32)
    return np.asarray([(fc[0], fc[k], fc[k + 1]) for fc in faces
                       for k in range(1, len(fc) - 1)], np.int32).reshape(-1, 3)


def load_ply(path):
    """PLY (ascii or binary_little_endian): vertex x / y / z, with nx / ny
    / nz and s / t (or u / v) when present, and the `face` element's list
    property, fan-triangulated. Without normals, area-weighted vertex
    normals."""
    with open(path, "rb") as f:
        fmt, elements = _ply_header(f)
        if fmt not in ("ascii", "binary_little_endian"):
            raise ValueError(f"unsupported PLY format: {fmt}")
        read = _ply_ascii_element if fmt == "ascii" else _ply_binary_element
        data = {name: (read(f, count, props), props)
                for name, count, props in elements}
    vert, vprops = data["vertex"]
    col = {p[0]: np.asarray(vert[p[0]]).astype(np.float32) for p in vprops
           if len(p) == 2}
    P = np.stack([col[c] for c in ("x", "y", "z")], -1)
    if all(c in col for c in ("nx", "ny", "nz")):
        N = np.stack([col[c] for c in ("nx", "ny", "nz")], -1)
    else:
        N = np.zeros_like(P)
    uv_names = ("s", "t") if "s" in col else ("u", "v")
    if all(c in col for c in uv_names):
        UV = np.stack([col[c] for c in uv_names], -1)
    else:
        UV = np.zeros((len(P), 2), np.float32)
    T = np.zeros((0, 3), np.int32)
    if "face" in data:
        face, fprops = data["face"]
        lp = next((p[0] for p in fprops if len(p) == 3), None)
        if lp is not None:
            T = _fan(face[lp])
    if _no_normals(N) and len(T):
        N = _area_normals(P, T)
    return TriMesh(P.astype(np.float32), N.astype(np.float32),
                   UV.astype(np.float32), T)


def geometry_key(stype, params, scene_dir="."):
    """Hashable identity of a shape's geometry (transform and material
    excluded), as the JAX package's mesh registry keys it: a `model` by its
    absolute path, `smooth`, `gltf_node` and `gltf_prim`. None = not
    cacheable."""
    if stype in ("quad", "quad_y", "quady"):
        return ("quad", params.get("width", 1.0), params.get("height", 1.0))
    if stype == "cube":
        return ("cube", params.get("x", 1.0), params.get("y", 0),
                params.get("z", 0))
    if stype == "sphere":
        return ("sphere", params.get("radius", 1.0),
                params.get("sub_div", 60))
    if stype == "model":
        fn = params.get("fn")
        if fn is None:
            return None
        return ("model", os.path.abspath(os.path.join(scene_dir, fn)),
                params.get("smooth", True), params.get("gltf_node"),
                params.get("gltf_prim"))
    return None


def make_shape(stype, params, scene_dir="."):
    """Shape factory keyed by the JSON `type` (a `model`'s `fn` relative to
    `scene_dir`)."""
    if stype in ("quad", "quad_y", "quady"):
        return make_quad(params.get("width", 1.0), params.get("height", 1.0))
    if stype == "cube":
        return make_cube(params.get("x", 1.0), params.get("y", 0) or None,
                         params.get("z", 0) or None)
    if stype == "sphere":
        return make_sphere(params.get("radius", 1.0), params.get("sub_div", 60))
    if stype == "model":
        return load_model(os.path.join(scene_dir, params.get("fn")),
                          smooth=params.get("smooth", True),
                          gltf_node=params.get("gltf_node"),
                          gltf_prim=params.get("gltf_prim"))
    raise ValueError(f"unknown shape type: {stype}")
