"""Parity of the port's flat BVH path (meshes through kernel K2) with the JAX
package on the same seeded inputs: the native builder's binding, the SAH
tree layout, the plain K2 walk (`intersect_packet_plain`) on the very same
tree as the JAX Pallas K2 (v3 and v2, interpret mode) and the dense sweep,
the mesh scene's loader, per-lane radiance and the regeneration wavefront.
The CUDA kernels are held against the plain walk on the card
(chip_smoke.py, and the `cuda`-marked test here)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vision_tpu_torch as vt
from tests.torch_parity import block_err, jax_scene_arrays, np_, tt
from tests import torch_walk_model as wm
from tests.torch_scenes import cbox_sphere
from vision_tpu import native as jnative
from vision_tpu.accel import intersect as jisect
from vision_tpu.accel import packet_bvh as jpb
from vision_tpu.core import rng as jrng
from vision_tpu.core.types import Ray as JRay
from vision_tpu.integrator import pt as jpt
from vision_tpu.scene.scene import Scene as JScene
from vision_tpu_torch import native as tnative
from vision_tpu_torch.accel import intersect as tisect
from vision_tpu_torch.accel import packet_bvh as tpb
from vision_tpu_torch.accel import packet_isect as pi
from vision_tpu_torch.core import rng as trng
from vision_tpu_torch.core.types import Ray as TRay
from vision_tpu_torch.integrator import pt as tpt
from vision_tpu_torch.scene.scene import scene_from_arrays

torch.set_num_threads(2)

# t between XLA and eager torch: op order only (1e-5 relative); ids may
# differ only on exact-t ties, which the two walks break by slot id (JAX
# K2) and by original id (the port)
T_RTOL = 1e-5


def _soup(n, seed=1, scale=4.0):
    """tests/test_packet.py's triangle soup."""
    rs = np.random.RandomState(seed)
    p0 = rs.rand(n, 3).astype(np.float32) * scale
    p1 = p0 + rs.rand(n, 3).astype(np.float32) * 0.4
    p2 = p0 + rs.rand(n, 3).astype(np.float32) * 0.4
    return p0, p1, p2


def _rays(R, seed=2, scale=4.0):
    rs = np.random.RandomState(seed)
    o = rs.rand(R, 3).astype(np.float32) * scale
    d = rs.randn(R, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _assert_same_hits(ta, ia, tb, ib):
    """Ids equal up to exact-t ties; t within T_RTOL."""
    ia, ib, ta, tb = (np.asarray(x) for x in (ia, ib, ta, tb))
    diff = ia != ib
    assert (np.abs(ta - tb) <= T_RTOL * np.abs(tb))[diff].all()
    assert diff.mean() <= 1e-3, diff.sum()
    np.testing.assert_allclose(ta, tb, rtol=T_RTOL)
    assert (ib >= 0).any() and (ib < 0).any()


@pytest.mark.parametrize("kind", ["tris", "boxes"])
def test_native_builder_matches_jax(kind):
    p0, p1, p2 = _soup(900)
    if kind == "tris":
        a = tnative.build_bvh_native(p0, p1, p2, max_leaf=4)
        b = jnative.build_bvh_native(p0, p1, p2, max_leaf=4)
    else:
        lo, hi = np.minimum(p0, p1), np.maximum(p0, p1)
        a = tnative.build_bvh_boxes_native(lo, hi, max_leaf=1)
        b = jnative.build_bvh_boxes_native(lo, hi, max_leaf=1)
    assert set(a) == set(b)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("bsize", [4, 64])
def test_build_matches_jax(bsize):
    """The same leaf size gives the JAX package's tree, field for field."""
    p0, p1, p2 = _soup(900)
    a = tpb.build_packet_bvh(p0, p1, p2, "cpu", bsize=bsize)
    b = jpb.build_packet_bvh(p0, p1, p2, brick=bsize)
    assert a.bsize == b.bsize == bsize
    for k in ("skip", "brick", "prim_order"):
        np.testing.assert_array_equal(np_(getattr(a, k)), np.asarray(getattr(b, k)))
    for k in ("lo", "hi"):
        np.testing.assert_array_equal(
            np_(getattr(a, k)),
            np.stack([np.asarray(getattr(b, f"{k}_{c}")) for c in "xyz"], -1))
    np.testing.assert_array_equal(np_(a.tri), np.asarray(b.tri)[:, :9])
    # the kernels' layout holds the same tree: one child-pair record per
    # inner node plus the root's header, three float4 per slot
    n_inner = int(((np_(a.brick) < 0) & (np_(a.brick) > -4)).sum())
    assert np_(a.nodes).shape == (n_inner + 1, 16)
    assert np_(a.heads).tolist() == [0]
    wm.check_records(a)
    tris = np_(a.tris)
    np.testing.assert_array_equal(tris[:, 0:3], np_(a.tri)[:, 0:3])
    np.testing.assert_array_equal(tris[:, 4:7], np_(a.tri)[:, 3:6])
    np.testing.assert_array_equal(tris[:, 8:11], np_(a.tri)[:, 6:9])
    np.testing.assert_array_equal(tris.view(np.int32)[:, 3],
                                  np_(a.prim_order))
    assert 0 < a.depth <= tpb.STACK


@pytest.fixture(scope="module")
def soup900():
    p0, p1, p2 = _soup(900)
    jt = jpb.build_packet_bvh(p0, p1, p2)
    arrays = {f.name: np.asarray(getattr(jt, f.name))
              for f in jt.__dataclass_fields__.values()
              if getattr(jt, f.name) is not None}
    return (p0, p1, p2), jt, tpb.packet_bvh_from_arrays(arrays, "cpu")


@pytest.mark.parametrize("kernel", ["v3", "v2"])
def test_plain_closest_matches_jax(soup900, kernel, monkeypatch):
    """The plain K2 on the carried-across JAX tree against the Pallas K2 in
    interpret mode and against the dense sweep (900 tris x 1024 rays)."""
    (p0, p1, p2), jt, tt_ = soup900
    if kernel == "v2":
        monkeypatch.setenv("VT_KERNEL", "v2")
    o, d = _rays(1024)
    jr = JRay.make(jnp.asarray(o), jnp.asarray(d))
    hj = jpb.intersect_packet(jr, jt, interpret=True)
    t, pid, uv = tpb.intersect_packet_plain(tt(o), tt(d), tt(jr.t_max), tt_)
    _assert_same_hits(np_(t), np_(pid), hj.t, hj.prim_id)
    same = np_(pid) == np.asarray(hj.prim_id)
    np.testing.assert_allclose(np_(uv)[same], np.asarray(hj.bary)[same],
                               atol=1e-5)
    hb = jisect.intersect_brute(jr, jnp.asarray(p0), jnp.asarray(p1 - p0),
                                jnp.asarray(p2 - p0))
    _assert_same_hits(np_(t), np_(pid), hb.t, hb.prim_id)


def test_plain_anyhit_matches_jax():
    """Any hit with t_max 1.5 (700 tris x 1024 rays) against the Pallas K2
    (interpret mode) and the dense sweep."""
    p0, p1, p2 = _soup(700, seed=3)
    jt = jpb.build_packet_bvh(p0, p1, p2)
    o, d = _rays(1024, seed=4)
    tmax = np.full(1024, 1.5, np.float32)
    jr = JRay(origin=jnp.asarray(o), direction=jnp.asarray(d),
              t_max=jnp.asarray(tmax))
    occ_j = np.asarray(jpb.intersect_packet(jr, jt, any_hit=True,
                                            interpret=True).prim_id) >= 0
    occ_b = np.asarray(jisect.occluded_brute(jr, jnp.asarray(p0),
                                             jnp.asarray(p1 - p0),
                                             jnp.asarray(p2 - p0)))
    for bsize in (4, int(jt.bsize)):
        tree = tpb.build_packet_bvh(p0, p1, p2, "cpu", bsize=bsize)
        occ = np_(tpb.intersect_packet_plain(tt(o), tt(d), tt(tmax), tree,
                                             any_hit=True))
        assert np.array_equal(occ, occ_j) and np.array_equal(occ, occ_b)
    assert occ.any() and not occ.all()


def test_plain_walk_equals_dense_sweep():
    """On the port's own tree (leaf 4) the plain K2 gives the port's dense
    sweep bit for bit: same Möller-Trumbore, same tie rule; dead lanes
    (t_max = 0) miss."""
    p0, p1, p2 = _soup(900, seed=5)
    tree = tpb.build_packet_bvh(p0, p1, p2, "cpu")
    o, d = _rays(2048, seed=6)
    tmax = np.where(np.arange(2048) % 7 == 0, 0.0, 1e30).astype(np.float32)
    tr = TRay(tt(o), tt(d), tt(tmax))
    t, pid, uv = pi.closest(tr.origin, tr.direction, tr.t_max, tree)
    h = tisect.intersect_brute(tr, tt(p0), tt(p1 - p0), tt(p2 - p0))
    assert torch.equal(pid, h.prim_id) and torch.equal(t, h.t)
    assert torch.equal(uv, h.bary)
    assert (pid[::7] == -1).all() and (pid >= 0).any()
    tr.t_max = torch.where(tr.t_max > 0, 1.0, 0.0)
    assert torch.equal(pi.anyhit(tr.origin, tr.direction, tr.t_max, tree),
                       tisect.occluded_brute(tr, tt(p0), tt(p1 - p0),
                                             tt(p2 - p0)))


@pytest.mark.parametrize("tree", ["bsize4", "bsize64", "jax"])
def test_records_hold_the_tree(soup900, tree):
    """The child-pair records of the 900-triangle soup's tree at leaf 4
    and 64, and of the JAX tree carried across, hold the tree node for
    node (boxes bit for bit, references, reached exactly once)."""
    p0, p1, p2 = soup900[0]
    if tree == "jax":
        t = soup900[2]
    else:
        t = tpb.build_packet_bvh(p0, p1, p2, "cpu", bsize=int(tree[5:]))
    wm.check_records(t)


@pytest.mark.parametrize("tree", ["bsize4", "jax"])
def test_kernel_walk_model_matches_plain(soup900, tree):
    """The kernels' walk over the records (the numpy model) against the
    plain K2 bit for bit, closest and any hit, on 2,048 rays with every
    7th lane dead (t_max 0); its stack never grows past the tree's depth."""
    (p0, p1, p2), _, jt = soup900
    t = jt if tree == "jax" else tpb.build_packet_bvh(p0, p1, p2, "cpu")
    o, d = _rays(2048, seed=12)
    tmax = np.where(np.arange(2048) % 7 == 0, 0.0, 1e30).astype(np.float32)
    args = (np_(t.nodes), np_(t.tris), t.bsize)
    (tm, idm, uvm, _), counts = wm.walk(o, d, tmax, *args)
    tp, idp, uvp = tpb.intersect_packet_plain(tt(o), tt(d), tt(tmax), t)
    assert np.array_equal(tm, np_(tp)) and np.array_equal(idm, np_(idp))
    assert np.array_equal(uvm, np_(uvp))
    assert (idm[::7] == -1).all() and (idm >= 0).mean() > 0.2
    assert counts[:, 5].max() <= t.depth and (counts[::7] == 0).all()
    st = np.where(idm >= 0, tm * 1.01, 2.0).astype(np.float32)
    st[::7] = 0.0
    occ, _ = wm.walk(o, d, st, *args, any_hit=True)
    occ_p = np_(tpb.intersect_packet_plain(tt(o), tt(d), tt(st), t,
                                           any_hit=True))
    assert np.array_equal(occ, occ_p) and occ.any() and not occ.all()


def test_plain_walk_raises_past_its_bound():
    """No silent step cap: a walk that does not end within n_nodes + 1
    steps (a broken tree with a skip cycle) raises."""
    p0, p1, p2 = _soup(64, seed=7)
    tree = tpb.build_packet_bvh(p0, p1, p2, "cpu")
    tree.skip = torch.where(tree.skip < 0, 0, tree.skip)   # loop to the root
    o, d = _rays(16, seed=8)
    with pytest.raises(RuntimeError, match="did not end"):
        tpb.intersect_packet_plain(tt(o), tt(d), torch.full((16,), 1e30), tree)


def test_wrapper_rejects_other_devices():
    p0, p1, p2 = _soup(64, seed=9)
    tree = tpb.build_packet_bvh(p0, p1, p2, "cpu")
    o = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match="want cuda or cpu"):
        pi.closest(o, o, torch.zeros(4, device="meta"), tree)
    with pytest.raises(ValueError, match="want cuda or cpu"):
        pi.anyhit(o, o, torch.zeros(4, device="meta"), tree)


@pytest.fixture(scope="module")
def mesh_scene():
    """cbox_sphere at sub_div 40: 6,276 triangles, over the dense limit."""
    s = cbox_sphere(32, sub_div=40)
    return s, JScene(s), vt.load_scene(s, device="cpu")


def test_loader_builds_the_bvh(mesh_scene):
    s, js, ps = mesh_scene
    d = ps.data
    assert d.pbvh is not None and d.ipbvh is None and js.data.pbvh is not None
    assert d.tri_geom.shape[0] == js.data.tri_p0.shape[0] == 6276
    assert d.pbvh.bsize == tpb.LEAF
    ref = jax_scene_arrays(js)
    for k in ("tri_pack", "inst_mat", "inst_light"):
        np.testing.assert_array_equal(np_(getattr(d, k)), ref[k])
    for k in ("tri_base", "tri_offset", "tri_count", "a_prob", "a_alias"):
        np.testing.assert_array_equal(np_(getattr(d.lights, k)),
                                      ref[f"lights.{k}"])
    assert d.world_radius == float(ref["world_radius"])
    # scene_from_arrays carries the JAX tree (leaf 64) across
    data, _, _ = scene_from_arrays(ref, "cpu")
    assert data.pbvh.bsize == int(js.data.pbvh.bsize)
    np.testing.assert_array_equal(np_(data.pbvh.skip),
                                  np.asarray(js.data.pbvh.skip))


def test_mesh_file_still_raises():
    """A mesh file raised before slice 7. A missing one now skips its
    shape with a warning, as in the JAX package, and the mesh scene still
    takes its BVH with the JAX package's triangles."""
    s = cbox_sphere(16, sub_div=40)
    s["shapes"].append({"type": "model", "name": "bunny",
                        "param": {"fn": "bunny.obj"}})
    with pytest.warns(UserWarning, match="skipping shape 'bunny'"):
        ps = vt.load_scene(s, device="cpu")
    with pytest.warns(UserWarning, match="skipping shape 'bunny'"):
        js = JScene(s)
    assert ps.data.pbvh is not None
    np.testing.assert_array_equal(np_(ps.data.tri_pack),
                                  np.asarray(js.data.tri_pack))


def test_radiance_per_lane(mesh_scene, monkeypatch):
    """Per-lane radiance at depth 2 on the same rays and RNG states. The
    JAX package runs its packet path (VT_PACKET=1, interpret mode), whose
    ray count skips gated shadow lanes as the port's does; XLA and eager
    rounding may flip a Russian-roulette or tie decision: at most 1% of
    lanes diverge and the means agree within 0.5%."""
    _, js, ps = mesh_scene
    monkeypatch.setenv("VT_PACKET", "1")
    res = 32
    R = res * res
    g = np.random.default_rng(0)
    p_film = (np.stack([np.arange(R) % res, np.arange(R) // res], -1)
              + g.random((R, 2))).astype(np.float32)
    seeds = g.integers(0, 2 ** 32, R, dtype=np.uint64)
    jray = js.camera.generate_ray(jnp.asarray(p_film))
    jst = jrng.seed(jnp.arange(R, dtype=jnp.uint32),
                    jnp.asarray(seeds.astype(np.uint32)))
    La, aa = jax.jit(lambda d, r, s: jpt.radiance(d, r, s, max_depth=2))(
        js.data, jray, jst)
    La = np.asarray(La)
    tray = ps.camera.generate_ray(tt(p_film))
    Lb, ab = tpt.radiance(ps.data, tray,
                          trng.seed(torch.arange(R), tt(seeds.astype(np.int64))),
                          max_depth=2)
    Lb = np_(Lb)
    bad = (np.abs(La - Lb) > 1e-4 + 1e-3 * np.abs(La)).any(-1)
    assert bad.mean() <= 0.01, bad.sum()
    assert La.mean() > 0.01
    assert abs(Lb.mean() / La.mean() - 1.0) < 0.005
    assert abs(int(ab["nrays"]) - float(aa["nrays"])) <= 0.01 * R


def test_render_wave_matches_jax(mesh_scene):
    """The regeneration wavefront at 32^2, 4 spp, both packages from the
    same seeds: 8x8 block error <= 0.01."""
    from vision_tpu.render import _wave_pass
    _, js, ps = mesh_scene
    ia, aa = _wave_pass(js.data, js.camera, js.filter, jnp.uint32(0), 4,
                        js.max_depth, js.min_depth, jnp.float32(js.rr_threshold))
    ib, ab = tpt.render_wave(ps.data, ps.camera, ps.filter, 0, 4,
                             ps.max_depth, ps.min_depth, ps.rr_threshold)
    werr, bias = block_err(np_(ib), np.asarray(ia))
    assert werr <= 0.01 and abs(bias) <= 0.01, (werr, bias)
    assert np.array_equal(np_(ab["smp"]), np.asarray(aa["smp"]))


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """K2's CUDA kernels against the plain walk on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    p0, p1, p2 = _soup(20000, seed=10)
    tree = tpb.build_packet_bvh(p0, p1, p2, "cuda")
    o, d = (torch.as_tensor(a, device="cuda") for a in _rays(65536, seed=11))
    tmax = torch.full((65536,), 1e30, device="cuda")
    t, pid, uv = pi.closest(o, d, tmax, tree)
    tp, pidp, uvp = tpb.intersect_packet_plain(o, d, tmax, tree)
    same = pid == pidp
    assert same.float().mean() > 1 - 1e-4
    assert torch.allclose(t, tp, rtol=1e-6)
    assert torch.allclose(uv[same], uvp[same], atol=1e-5)
    tmax = torch.where(pidp >= 0, tp * 1.2, 2.0)
    occ = pi.anyhit(o, d, tmax, tree)
    assert (occ != tpb.intersect_packet_plain(o, d, tmax, tree, any_hit=True)
            ).float().mean() <= 1e-4
