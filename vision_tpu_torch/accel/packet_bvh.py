"""SAH BVH of a mesh scene: the trees that K2 (flat) and K3 (instanced)
walk, and the plain PyTorch versions of both walks.

Counterpart of `vision_tpu/accel/packet_bvh.py` (`PacketBVH`,
`build_packet_bvh`, `InstancedPBVH`, `build_instanced_pbvh`). The trees come
from the same native binned-SAH builder (`vision_tpu_torch/native.py`), in
the same flat layout: DFS preorder, `skip[i]` is the next node after i's
subtree (-1 at the end), the right child of an inner node i is
`skip[i + 1]`, and `brick[i]` is a leaf's brick id (>= 0), an inner node's
split axis as -(axis + 1), or, in a TLAS, -4 - instance. Brick b holds the
`bsize` triangle slots [b * bsize, (b + 1) * bsize); `prim_order` maps a
slot to the original triangle id, -1 on padding (padding trails the valid
slots of its brick).

What the TPU layout needed and the card does not is dropped: the leaf
doubling that kept the node arrays inside the TPU's scalar memory, the
128-lane padding of `tri`, the Woop columns, the f32 slot-id bound (ids are
int32 here), and the per-octant window tables of kernel v3. The leaf size
is the card's own (LEAF); the kernels accept any `bsize`, such as a JAX
tree's 64.

Each tree also carries the layout the CUDA kernels read
(`csrc/packet_isect.cu`), built once on the host from the same tree:
child-pair records `nodes [M, 16]` f32, four float4 each. An inner node's
record holds both children: (lo_l.xyz, ref_l), (hi_l.xyz, ref_r),
(lo_r.xyz, split axis), (hi_r.xyz, 0), so one step of the walk is one
round of independent loads and no box is fetched twice. A reference is
`index << 2 | kind`: kind 0 an inner node's record, 1 a leaf's brick, 2 a
TLAS leaf's instance; -1 is none. Each tree's root has a header record
(root.lo.xyz, ref_root), (root.hi.xyz, -1) ahead of its own, so the walk
tests the root box once before it starts; `heads` lists them (the flat
tree's is record 0; a TLAS's first, then one per mesh tree). `tris
[slots, 12]` f32 holds three float4 per slot, (p0.xyz, original id), (e1,
0), (e2, 0), and an instanced tree's `insts [I, 16]` f32 one record per
instance: its world-to-object rows as three float4 (m0 m1 m2 t) and the
header record of its mesh tree; ints are stored as their bits. `depth` is
the most inner nodes on any root-to-leaf path, which bounds the kernels'
stack.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import native
from .intersect import _mt_batch

LEAF = 4      # triangles per leaf for the card's one-thread-per-ray walk
STACK = 96    # entries of the kernels' traversal stack (kStack)
_I32_MAX = 2 ** 31 - 1
REF_INNER, REF_LEAF, REF_INSTANCE = 0, 1, 2  # reference kinds (ref & 3)
REF_NONE = -1                                # no reference


@dataclass
class PacketBVH:
    skip: torch.Tensor        # [N] int32
    brick: torch.Tensor       # [N] int32
    lo: torch.Tensor          # [N, 3] f32
    hi: torch.Tensor          # [N, 3] f32
    tri: torch.Tensor         # [slots, 9] f32 p0 e1 e2
    prim_order: torch.Tensor  # [slots] int32 original id, -1 = padding
    nodes: torch.Tensor       # [M, 16] f32 child-pair records
    tris: torch.Tensor        # [slots, 12] f32 kernel layout
    heads: torch.Tensor       # [roots] int32 header record of each tree
    bsize: int
    depth: int

    @property
    def n_nodes(self):
        return self.skip.shape[0]


@dataclass
class InstancedPBVH(PacketBVH):
    """One node array [TLAS | BLAS_0 | BLAS_1 | ...]: the TLAS over
    instance boxes in world space, then each unique mesh's tree in object
    space (links offset to the global numbering, `prim_order` gives global
    object-space ids). A TLAS leaf holds instance i = -4 - brick."""
    inst_root: torch.Tensor = None  # [I] int32 root node of i's mesh tree
    inst_w2o: torch.Tensor = None   # [I, 12] f32 rows (m0 m1 m2 t): p_obj = M p + t
    insts: torch.Tensor = None      # [I, 16] f32 kernel layout: w2o, header
    max_steps: int = 0              # bound of one lane's walk (node visits)

    @property
    def n_inst(self):
        return self.inst_root.shape[0]


# ---------------------------------------------------------------------------
# host build
# ---------------------------------------------------------------------------

def _bricks(r, p0, p1, p2, bsize, brick_base=0, id_base=0):
    """Leaf triangle table of one builder tree: (brick codes [N], tri
    [L*bsize, 9], prim_order [L*bsize]) with ids offset by id_base."""
    count = r["count"].astype(np.int64)
    first = r["first"].astype(np.int64)
    order = r["order"].astype(np.int64)
    leaves = np.nonzero(count > 0)[0]
    nb = max(len(leaves), 1)
    brick = -(r["axis"].astype(np.int64) + 1)
    brick[leaves] = brick_base + np.arange(len(leaves))
    tri = np.zeros((nb * bsize, 9), np.float32)
    po = np.full(nb * bsize, -1, np.int64)
    if len(leaves):
        ks = np.arange(bsize)[None, :]
        valid = (ks < count[leaves][:, None]).ravel()
        src = order[np.clip(first[leaves][:, None] + ks, 0, len(order) - 1)
                    .ravel()[valid]]
        tri[valid, 0:3] = p0[src]
        tri[valid, 3:6] = p1[src] - p0[src]
        tri[valid, 6:9] = p2[src] - p0[src]
        po[valid] = id_base + src
    return brick, tri, po, nb


def _depth(skip, brick, roots):
    """Most inner nodes on a path from one of `roots` down to a leaf, per
    root (iterative: a preorder parent precedes its children)."""
    d = [0] * len(skip)
    inner = ((brick < 0) & (brick > -4)).tolist()
    sk = skip.tolist()
    for i in range(len(sk)):
        if inner[i]:
            d[i + 1] = d[i] + 1
            d[sk[i + 1]] = d[i] + 1
    d = np.asarray(d)
    bounds = list(roots[1:]) + [len(sk)]
    return [int(d[a:b].max()) for a, b in zip(roots, bounds)]


def _refs(skip, brick, roots):
    """(ref [N] of every node, record [N] of each inner node, header record
    of each root, record count): records in preorder, each root's header
    just ahead of the root's own record."""
    inner = (brick < 0) & (brick > -4)
    is_root = np.zeros(len(skip), bool)
    is_root[roots] = True
    per = inner.astype(np.int64) + is_root
    first = np.cumsum(per) - per
    rec = first + is_root
    ref = np.where(inner, rec << 2 | REF_INNER,
                   np.where(brick >= 0, brick << 2 | REF_LEAF,
                            (-4 - brick) << 2 | REF_INSTANCE))
    m = int(per.sum())
    if max(m, brick.max() + 1, -3 - brick.min()) >= 2 ** 29:
        raise ValueError("BVH too large for the kernels' 29-bit references")
    return ref, rec, first[roots], m


def _kernel_layout(skip, brick, lo, hi, tri, prim_order, roots):
    """(nodes [M, 16], tris [slots, 12], heads [roots]) as the kernels read
    them."""
    skip = skip.astype(np.int64)
    brick = brick.astype(np.int64)
    ref, rec, heads, m = _refs(skip, brick, roots)
    nodes = np.zeros((m, 16), np.float32)
    iv = nodes.view(np.int32)
    i = np.nonzero((brick < 0) & (brick > -4))[0]
    left, right, r = i + 1, skip[i + 1], rec[i]
    nodes[r, 0:3], iv[r, 3] = lo[left], ref[left]
    nodes[r, 4:7], iv[r, 7] = hi[left], ref[right]
    nodes[r, 8:11], iv[r, 11] = lo[right], -(brick[i] + 1)
    nodes[r, 12:15] = hi[right]
    nodes[heads, 0:3], iv[heads, 3] = lo[roots], ref[roots]
    nodes[heads, 4:7], iv[heads, 7] = hi[roots], REF_NONE
    tris = np.zeros((len(tri), 12), np.float32)
    tris[:, 0:3] = tri[:, 0:3]
    tris[:, 4:7] = tri[:, 3:6]
    tris[:, 8:11] = tri[:, 6:9]
    tris.view(np.int32)[:, 3] = prim_order
    return nodes, tris, heads.astype(np.int32)


def _fields(device, skip, brick, lo, hi, tri, prim_order, roots=(0,)):
    """Host arrays -> the tensor fields shared by both tree kinds."""
    skip = np.asarray(skip, np.int32)
    brick = np.asarray(brick, np.int32)
    lo = np.asarray(lo, np.float32).reshape(-1, 3)
    hi = np.asarray(hi, np.float32).reshape(-1, 3)
    tri = np.ascontiguousarray(np.asarray(tri, np.float32)[:, :9])
    prim_order = np.asarray(prim_order, np.int32)
    nodes, tris, heads = _kernel_layout(skip, brick, lo, hi, tri, prim_order,
                                        list(roots))

    def t(a):
        return torch.as_tensor(np.array(a), device=device)
    return dict(skip=t(skip), brick=t(brick), lo=t(lo), hi=t(hi), tri=t(tri),
                prim_order=t(prim_order), nodes=t(nodes), tris=t(tris),
                heads=t(heads))


def _check_depth(depth):
    if depth > STACK:
        raise ValueError(f"BVH depth {depth} exceeds the kernels' stack of "
                         f"{STACK} entries")
    return depth


def packet_bvh_from_arrays(a, device):
    """A flat tree from the JAX `PacketBVH` fields taken as numpy: `skip`,
    `brick`, `lo_x` .. `hi_z`, `tri` (its first 9 columns are read),
    `prim_order`, `bsize`."""
    lo = np.stack([np.asarray(a[f"lo_{c}"]) for c in "xyz"], -1)
    hi = np.stack([np.asarray(a[f"hi_{c}"]) for c in "xyz"], -1)
    skip, brick = np.asarray(a["skip"]), np.asarray(a["brick"])
    f = _fields(device, skip, brick, lo, hi, np.asarray(a["tri"]),
                np.asarray(a["prim_order"]))
    depth = _check_depth(_depth(skip, brick, [0])[0])
    return PacketBVH(**f, bsize=int(a["bsize"]), depth=depth)


def build_packet_bvh(p0, p1, p2, device, bsize=LEAF):
    """Native SAH build over triangles p0/p1/p2 [T, 3] (leaves of at most
    `bsize` triangles, padded to `bsize` slots) -> PacketBVH on `device`."""
    p0, p1, p2 = (np.asarray(x, np.float32) for x in (p0, p1, p2))
    r = native.build_bvh_native(p0, p1, p2, max_leaf=bsize)
    brick, tri, po, _ = _bricks(r, p0, p1, p2, bsize)
    f = _fields(device, r["skip"], brick, r["lo"], r["hi"], tri, po)
    depth = _check_depth(_depth(r["skip"], brick, [0])[0])
    return PacketBVH(**f, bsize=bsize, depth=depth)


def _instanced(device, skip, brick, lo, hi, tri, prim_order, inst_root,
               inst_w2o, bsize):
    skip, brick = np.asarray(skip), np.asarray(brick)
    inst_root = np.asarray(inst_root, np.int32)
    roots = sorted(set(inst_root.tolist()))
    depths = _depth(skip, brick, [0] + roots)
    # the stack holds TLAS entries below those of one mesh tree
    depth = _check_depth(depths[0] + max(depths[1:]))
    # a lane visits each TLAS node once and each mesh tree's nodes once
    # per instance it enters
    size = dict(zip(roots, np.diff(roots + [len(skip)]).tolist()))
    max_steps = roots[0] + sum(size[int(r)] for r in inst_root) + 1
    f = _fields(device, skip, brick, lo, hi, tri, prim_order, [0] + roots)
    w2o = np.asarray(inst_w2o, np.float32).reshape(-1, 12)
    insts = np.zeros((len(inst_root), 16), np.float32)
    insts[:, :12] = w2o
    head_of = dict(zip(roots, f["heads"].cpu().tolist()[1:]))
    insts.view(np.int32)[:, 12] = [head_of[int(r)] for r in inst_root]
    return InstancedPBVH(
        **f, bsize=bsize, depth=depth,
        inst_root=torch.as_tensor(inst_root, device=device),
        inst_w2o=torch.as_tensor(w2o.copy(), device=device),
        insts=torch.as_tensor(insts, device=device),
        max_steps=int(max_steps))


def instanced_pbvh_from_arrays(a, device):
    """An instanced tree from the JAX `InstancedPBVH` fields as numpy
    (those of `packet_bvh_from_arrays` plus `inst_root`, `inst_w2o`)."""
    lo = np.stack([np.asarray(a[f"lo_{c}"]) for c in "xyz"], -1)
    hi = np.stack([np.asarray(a[f"hi_{c}"]) for c in "xyz"], -1)
    return _instanced(device, a["skip"], a["brick"], lo, hi,
                      np.asarray(a["tri"]), a["prim_order"], a["inst_root"],
                      a["inst_w2o"], int(a["bsize"]))


def build_instanced_pbvh(meshes, instances, device, bsize=LEAF):
    """meshes: (p0, p1, p2) object-space triangles of each unique mesh.
    instances: (mesh id, o2w [4, 4] in row-vector form, world = p @ m[:3, :3]
    + m[3, :3]). Returns the InstancedPBVH on `device`."""
    blas, tri_base = [], [0]
    for (p0, p1, p2) in meshes:
        blas.append(native.build_bvh_native(p0, p1, p2, max_leaf=bsize))
        tri_base.append(tri_base[-1] + len(p0))

    # instance world boxes (the 8 corners of the mesh root box) and the
    # world-to-object rows p_obj = R p + t
    n_inst = len(instances)
    w_lo = np.zeros((n_inst, 3), np.float32)
    w_hi = np.zeros((n_inst, 3), np.float32)
    w2o = np.zeros((n_inst, 12), np.float32)
    for i, (mid, o2w) in enumerate(instances):
        m = np.asarray(o2w, np.float64)
        lo, hi = blas[mid]["lo"][0], blas[mid]["hi"][0]
        cs = np.array([[x, y, z] for x in (lo[0], hi[0])
                       for y in (lo[1], hi[1]) for z in (lo[2], hi[2])])
        wc = cs @ m[:3, :3] + m[3, :3]
        w_lo[i], w_hi[i] = wc.min(0), wc.max(0)
        inv = np.linalg.inv(np.vstack([np.hstack([m[:3, :3], np.zeros((3, 1))]),
                                       np.hstack([m[3, :3], [1.0]])]))
        w2o[i] = np.hstack([inv[:3, :3].T, inv[3, :3][:, None]]).reshape(-1)

    tl = native.build_bvh_boxes_native(w_lo, w_hi, max_leaf=1)
    nt = len(tl["first"])
    tb = -(tl["axis"].astype(np.int64) + 1)
    tlv = np.nonzero(tl["count"] > 0)[0]
    tb[tlv] = -4 - tl["order"][tl["first"][tlv]].astype(np.int64)
    skips, bricks, los, his = [tl["skip"]], [tb], [tl["lo"]], [tl["hi"]]
    tris, pos, node_base = [], [], []
    base, bbase = nt, 0
    for mi, r in enumerate(blas):
        p0, p1, p2 = (np.asarray(a, np.float32) for a in meshes[mi])
        node_base.append(base)
        sk = r["skip"].astype(np.int64)
        skips.append(np.where(sk >= 0, sk + base, -1))
        brick, tri, po, nb = _bricks(r, p0, p1, p2, bsize, bbase, tri_base[mi])
        bricks.append(brick)
        los.append(r["lo"])
        his.append(r["hi"])
        tris.append(tri)
        pos.append(po)
        base += len(sk)
        bbase += nb
    inst_root = [node_base[mid] for (mid, _) in instances]
    return _instanced(device, np.concatenate(skips), np.concatenate(bricks),
                      np.concatenate(los), np.concatenate(his),
                      np.concatenate(tris), np.concatenate(pos), inst_root,
                      w2o, bsize)


# ---------------------------------------------------------------------------
# plain walks (the plain versions of K2 and K3)
# ---------------------------------------------------------------------------

def _rcp(v):
    """1 / v with each component clamped away from 0 at +-1e-12."""
    a = torch.where(torch.abs(v) > 1e-12, v,
                    torch.where(v >= 0, 1e-12, -1e-12))
    return 1.0 / a


def _slab(lo, hi, o, inv):
    """(tnear, tfar) of boxes lo/hi [A, 3] against rays o / inv [A, 3]."""
    a = (lo - o) * inv
    b = (hi - o) * inv
    n = torch.minimum(a, b)
    f = torch.maximum(a, b)
    tnear = torch.maximum(torch.maximum(n[:, 0], n[:, 1]),
                          torch.clamp_min(n[:, 2], 0.0))
    tfar = torch.minimum(torch.minimum(f[:, 0], f[:, 1]), f[:, 2])
    return tnear, tfar


def _to_object(w2o, o, d):
    """World rays -> object space by rows (m0 m1 m2 t) [A, 12]."""
    m = w2o.reshape(-1, 3, 4)
    oo = (m[:, :, 0] * o[:, 0:1] + m[:, :, 1] * o[:, 1:2]
          + m[:, :, 2] * o[:, 2:3] + m[:, :, 3])
    dd = m[:, :, 0] * d[:, 0:1] + m[:, :, 1] * d[:, 1:2] + m[:, :, 2] * d[:, 2:3]
    return oo, dd


def _walk(origin, direction, t_max, tree, any_hit, instanced):
    """Lock-step skip-link walk of every lane over `tree`: a node whose box
    is hit (tfar >= tnear, tnear <= best t) is entered (inner: node + 1), a
    leaf is swept, anything else goes to skip[node]. At a TLAS leaf a lane
    saves skip[node], moves its ray to the instance's object space and
    walks that mesh's tree from its root; when that walk ends (-1) it goes
    back to the saved node in world space. Lanes with t_max <= 0 do not
    walk. A lane visits each node at most once per tree it walks, so more
    iterations than that bound raise."""
    dev = origin.device
    R = origin.shape[0]
    o, d = origin, direction
    inv = _rcp(d)
    best_t = t_max.clone()
    best_id = torch.full((R,), -1, dtype=torch.int32, device=dev)
    best_uv = torch.zeros((R, 2), dtype=torch.float32, device=dev)
    best_inst = torch.full((R,), -1, dtype=torch.int32, device=dev)
    occ = torch.zeros((R,), dtype=torch.bool, device=dev)
    node = torch.where(t_max > 0, 0, -1).to(torch.int64)
    inst = torch.full((R,), -1, dtype=torch.int64, device=dev)
    resume = torch.full((R,), -1, dtype=torch.int64, device=dev)
    bound = tree.max_steps if instanced else tree.n_nodes + 1
    skip = tree.skip.long()
    brick = tree.brick.long()
    slot = torch.arange(tree.bsize, device=dev)
    idx = torch.nonzero(node >= 0).flatten()
    steps = 0
    while idx.numel():
        steps += 1
        if steps > bound:
            raise RuntimeError(f"BVH walk did not end in {bound} steps")
        n = node[idx]
        code = brick[n]
        tnear, tfar = _slab(tree.lo[n], tree.hi[n], o[idx], inv[idx])
        hit = (tfar >= tnear) & (tnear <= best_t[idx])
        leaf = hit & (code >= 0)
        if bool(leaf.any()):
            li = idx[leaf]
            s = code[leaf][:, None] * tree.bsize + slot           # [L, bsize]
            tri = tree.tri[s]
            po = tree.prim_order[s]
            t, u, v, ok = _mt_batch(o[li], d[li], tri[..., 0:3],
                                    tri[..., 3:6], tri[..., 6:9])
            ok = ok & (po >= 0)
            if any_hit:
                occ[li] |= torch.any(ok & (t < t_max[li, None]), dim=-1)
            else:
                t = torch.where(ok, t, torch.inf)
                tmin = torch.amin(t, dim=-1)
                at_min = t == tmin[:, None]
                pid = torch.amin(torch.where(at_min, po, _I32_MAX), dim=-1)
                k = torch.argmax((at_min & (po == pid[:, None])).to(torch.int8),
                                 dim=-1)[:, None]
                bt, bid = best_t[li], best_id[li]
                better = ok.any(-1) & (tmin < bt)
                tie = ok.any(-1) & (tmin == bt) & (bid >= 0)
                if instanced:
                    li_inst = inst[li].to(torch.int32)
                    tie = tie & ((pid < bid) | ((pid == bid)
                                                & (li_inst < best_inst[li])))
                    better = better | tie
                    best_inst[li] = torch.where(better, li_inst, best_inst[li])
                else:
                    better = better | (tie & (pid < bid))
                best_t[li] = torch.where(better, tmin, bt)
                best_id[li] = torch.where(better, pid, bid)
                uv = torch.stack([torch.gather(u, 1, k)[:, 0],
                                  torch.gather(v, 1, k)[:, 0]], -1)
                best_uv[li] = torch.where(better[:, None], uv, best_uv[li])
        nxt = torch.where(hit & (code < 0) & (code > -4), n + 1, skip[n])
        if instanced:
            enter = hit & (code <= -4)
            if bool(enter.any()):
                ei = idx[enter]
                k = -4 - code[enter]
                resume[ei] = skip[n[enter]]
                inst[ei] = k
                nxt[enter] = tree.inst_root[k].long()
                oo, dd = _to_object(tree.inst_w2o[k], origin[ei], direction[ei])
                if o is origin:
                    o, d, inv = o.clone(), d.clone(), inv.clone()
                o[ei], d[ei], inv[ei] = oo, dd, _rcp(dd)
            back = (nxt < 0) & (inst[idx] >= 0)
            if bool(back.any()):
                bi = idx[back]
                nxt[back] = resume[bi]
                inst[bi] = -1
                o[bi], d[bi], inv[bi] = origin[bi], direction[bi], _rcp(direction[bi])
        if any_hit:
            nxt = torch.where(occ[idx], -1, nxt)
        node[idx] = nxt
        idx = idx[nxt >= 0]
    if any_hit:
        return occ
    return best_t, best_id, best_uv, best_inst


def intersect_packet_plain(origin, direction, t_max, pbvh, any_hit=False):
    """Plain K2. Closest: (t [R], prim_id [R] int32 original id, bary
    [R, 2]); a miss gives t = t_max, id -1, bary 0; an exact-t tie keeps
    the smaller id. Any hit: [R] bool, a hit with 0 < t < t_max."""
    out = _walk(origin, direction, t_max, pbvh, any_hit, False)
    return out if any_hit else out[:3]


def intersect_packet_inst_plain(origin, direction, t_max, ipbvh, any_hit=False):
    """Plain K3: closest gives (t, prim_id as a global object-space id,
    bary, inst [R] int32, -1 on a miss); ties keep the smaller (id, inst).
    Any hit: [R] bool."""
    return _walk(origin, direction, t_max, ipbvh, any_hit, True)
