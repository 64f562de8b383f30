"""A numpy model of the K2/K3 CUDA kernels' walk (`csrc/packet_isect.cu`)
over the child-pair records that `vision_tpu_torch/accel/packet_bvh.py`
builds (`nodes`, `tris`, `heads`, `insts`), for the CPU tests: the kernels
cannot run here, so this holds their layout and their walk against the
plain walks. Lanes step in lock-step, each with its own ordered stack, in
the kernel's float32 operation order:

  * a header record's box is tested before the walk (and, in object space,
    when a ray enters an instance);
  * at an inner record both children's boxes come from the record; if both
    are hit the near child by the direction's sign along the split axis is
    entered and the far one pushed with its tnear; a popped entry is
    skipped when best t has dropped below its tnear;
  * a leaf's slots are swept in order up to the first padding slot;
  * at a TLAS leaf the ray moves to object space, and the world ray comes
    back when the stack is down to where the mesh walk began.

Also returns per-ray counts as the kernels' counting build records them:
inner records, leaves, box tests, triangle tests, instance entries and the
deepest stack."""
import numpy as np

F = np.float32
NONE = -1


def _rcp(v):
    a = np.where(np.abs(v) > F(1e-12), v,
                 np.where(v >= 0, F(1e-12), F(-1e-12))).astype(F)
    return F(1.0) / a


def _slab(lo, hi, o, inv, lim):
    a = (lo - o) * inv
    b = (hi - o) * inv
    n, f = np.minimum(a, b), np.maximum(a, b)
    tn = np.maximum(np.maximum(n[:, 0], n[:, 1]), np.maximum(n[:, 2], F(0)))
    tf = np.minimum(np.minimum(f[:, 0], f[:, 1]), f[:, 2])
    return (tf >= tn) & (tn <= lim), tn


def _mt(o, d, p0, e1, e2):
    """Möller-Trumbore in mt.cuh's order, all [L, 3] float32."""
    (ox, oy, oz), (dx, dy, dz) = o.T, d.T
    (p0x, p0y, p0z), (e1x, e1y, e1z), (e2x, e2y, e2z) = p0.T, e1.T, e2.T
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    big = np.abs(det) > F(1e-9)
    inv = np.where(big, F(1.0) / np.where(det == 0, F(1.0), det), F(0.0))
    tvx, tvy, tvz = ox - p0x, oy - p0y, oz - p0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * inv
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv
    ok = (big & (u >= F(-1e-6)) & (v >= F(-1e-6)) & (u + v <= F(1.000001))
          & (t > F(0)))
    return t, u, v, ok


def walk(o, d, t_max, nodes, tris, bsize, insts=None, any_hit=False,
         stack=96):
    """Walk rays o, d [R, 3], t_max [R] (float32 numpy) over the records.
    Returns (t, id, bary, inst) or occ, and counts [R, 6]."""
    o, d, t_max = (np.asarray(x, F) for x in (o, d, t_max))
    R = len(o)
    rec = nodes.reshape(-1, 4, 4)
    bits = nodes.view(np.int32)
    slot = tris.reshape(-1, 3, 4)
    slot_id = tris.view(np.int32)[:, 3]
    ro, rd, rinv = o.copy(), d.copy(), _rcp(d)
    best_t, best_uv = t_max.copy(), np.zeros((R, 2), F)
    best_id = np.full(R, -1, np.int64)
    best_inst = np.full(R, -1, np.int64)
    occ = np.zeros(R, bool)
    cur = np.full(R, NONE, np.int64)
    sp = np.zeros(R, np.int64)
    base = np.zeros(R, np.int64)
    inst = np.full(R, -1, np.int64)
    stk = np.zeros((R, stack), np.int64)
    stk_t = np.zeros((R, stack), F)
    counts = np.zeros((R, 6), np.int64)

    def pop(lanes):
        out = np.full(len(lanes), NONE, np.int64)
        todo = np.arange(len(lanes))
        while todo.size:
            ln = lanes[todo]
            back = ln[(inst[ln] >= 0) & (sp[ln] == base[ln])]
            ro[back], rd[back], rinv[back] = o[back], d[back], _rcp(d[back])
            inst[back] = -1
            keep = sp[ln] > 0
            todo, ln = todo[keep], ln[keep]
            sp[ln] -= 1
            ok = stk_t[ln, sp[ln]] <= best_t[ln]
            out[todo[ok]] = stk[ln, sp[ln]][ok]
            todo = todo[~ok]
        return out

    def enter_tree(lanes, head):
        counts[lanes, 2] += 1
        hit, _ = _slab(rec[head, 0, :3], rec[head, 1, :3], ro[lanes],
                       rinv[lanes], best_t[lanes])
        out = np.where(hit, bits[head, 3], NONE).astype(np.int64)
        out[~hit] = pop(lanes[~hit])
        return out

    live = np.nonzero(t_max > 0)[0]
    cur[live] = enter_tree(live, np.zeros(len(live), np.int64))
    while True:
        act = np.nonzero(cur != NONE)[0]
        if not act.size:
            break
        kind = cur[act] & 3
        # inner records
        L = act[kind == 0]
        if L.size:
            r = cur[L] >> 2
            counts[L, 0] += 1
            counts[L, 2] += 2
            hl, tl = _slab(rec[r, 0, :3], rec[r, 1, :3], ro[L], rinv[L], best_t[L])
            hr, tr = _slab(rec[r, 2, :3], rec[r, 3, :3], ro[L], rinv[L], best_t[L])
            rl, rr = bits[r, 3].astype(np.int64), bits[r, 7].astype(np.int64)
            da = rd[L, bits[r, 11]]
            lf = da >= 0
            both = hl & hr
            B = L[both]
            stk[B, sp[B]] = np.where(lf, rr, rl)[both]
            stk_t[B, sp[B]] = np.where(lf, tr, tl)[both]
            sp[B] += 1
            counts[B, 5] = np.maximum(counts[B, 5], sp[B])
            cur[L] = np.where(both, np.where(lf, rl, rr), np.where(hl, rl, rr))
            miss = ~hl & ~hr
            cur[L[miss]] = pop(L[miss])
        # leaves
        L = act[kind == 1]
        if L.size:
            counts[L, 1] += 1
            first = (cur[L] >> 2) * bsize
            going = np.ones(len(L), bool)
            for k in range(bsize):
                s = first + k
                pid = slot_id[s].astype(np.int64)
                going &= pid >= 0
                counts[L[going], 3] += 1
                q = slot[s]
                t, u, v, ok = _mt(ro[L], rd[L], q[:, 0, :3], q[:, 1, :3],
                                  q[:, 2, :3])
                ok &= going
                if any_hit:
                    hit = ok & (t < t_max[L])
                    occ[L[hit]] = True
                    going &= ~hit
                    continue
                bt, bid = best_t[L], best_id[L]
                tie = (pid < bid) | ((pid == bid) & (inst[L] < best_inst[L])
                                     if insts is not None else False)
                better = ok & ((t < bt) | ((t == bt) & (bid >= 0) & tie))
                b = L[better]
                best_t[b], best_id[b] = t[better], pid[better]
                best_uv[b] = np.stack([u, v], -1)[better]
                best_inst[b] = inst[b]
            done = occ[L] if any_hit else np.zeros(len(L), bool)
            cur[L[done]] = NONE
            cur[L[~done]] = pop(L[~done])
        # TLAS leaves: enter the instance's mesh tree in object space
        L = act[kind == 2]
        if L.size:
            counts[L, 4] += 1
            k = cur[L] >> 2
            inst[L] = k
            m = insts[k, :12].reshape(-1, 3, 4)
            wo, wd = o[L], d[L]
            ro[L] = (m[:, :, 0] * wo[:, 0:1] + m[:, :, 1] * wo[:, 1:2]
                     + m[:, :, 2] * wo[:, 2:3] + m[:, :, 3])
            rd[L] = (m[:, :, 0] * wd[:, 0:1] + m[:, :, 1] * wd[:, 1:2]
                     + m[:, :, 2] * wd[:, 2:3])
            rinv[L] = _rcp(rd[L])
            base[L] = sp[L]
            cur[L] = enter_tree(L, insts.view(np.int32)[k, 12].astype(np.int64))
    if any_hit:
        return occ, counts
    return (best_t, best_id.astype(np.int32), best_uv,
            best_inst.astype(np.int32)), counts


def check_records(tree):
    """Assert that the child-pair records of `tree` (a PacketBVH or an
    InstancedPBVH on the CPU) hold its preorder arrays: every inner node's
    record holds both children's boxes bit for bit and its split axis, a
    leaf's reference names its brick, a TLAS leaf's its instance, each
    root's header its box, and every node and record is reached exactly
    once from the headers. An instance's record holds its world-to-object
    rows and its mesh tree's header."""
    skip = tree.skip.numpy().astype(np.int64)
    brick = tree.brick.numpy().astype(np.int64)
    lo = tree.lo.numpy().view(np.int32)
    hi = tree.hi.numpy().view(np.int32)
    bits = tree.nodes.numpy().view(np.int32)
    heads = tree.heads.numpy()
    instanced = getattr(tree, "insts", None) is not None
    roots = [0]
    if instanced:
        roots += sorted(set(tree.inst_root.tolist()))
    assert len(heads) == len(roots) and heads[0] == 0
    node_seen = np.zeros(len(skip), int)
    rec_seen = np.zeros(len(bits), int)
    todo = []

    def child(j, box_lo, box_hi, ref):
        node_seen[j] += 1
        assert (box_lo == lo[j]).all() and (box_hi == hi[j]).all(), j
        if brick[j] >= 0:
            assert ref == brick[j] << 2 | 1, (j, ref)
        elif brick[j] <= -4:
            assert instanced and ref == (-4 - brick[j]) << 2 | 2, (j, ref)
        else:
            assert ref >= 0 and ref & 3 == 0, (j, ref)
            todo.append((ref >> 2, j))

    for h, root in zip(heads, roots):
        rec_seen[h] += 1
        child(root, bits[h, 0:3], bits[h, 4:7], bits[h, 3])
        assert bits[h, 7] == NONE
    while todo:
        r, i = todo.pop()
        rec_seen[r] += 1
        child(i + 1, bits[r, 0:3], bits[r, 4:7], bits[r, 3])
        child(skip[i + 1], bits[r, 8:11], bits[r, 12:15], bits[r, 7])
        assert bits[r, 11] == -(brick[i] + 1)
    assert (node_seen == 1).all() and (rec_seen == 1).all()
    if instanced:
        ib = tree.insts.numpy().view(np.int32)
        assert (ib[:, :12] == tree.inst_w2o.numpy().view(np.int32)).all()
        head_of = dict(zip(roots, heads.tolist()))
        assert ib[:, 12].tolist() == [head_of[r] for r in tree.inst_root.tolist()]
