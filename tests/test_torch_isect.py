"""Parity of the port's dense ray/triangle sweep (the plain versions of
kernel K1, vision_tpu_torch.accel.intersect / dense_isect) with the JAX
package's intersect_brute / occluded_brute and the Pallas K1 in interpret
mode, on the same seeded inputs. The CUDA kernels themselves are held
against the plain versions on the card (chip_smoke.py, and the `cuda`-marked
test here)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_sweep_model as sm
from tests.torch_parity import np_, tt
from vision_tpu.accel import intersect as jisect
from vision_tpu.core.types import Ray as JRay
from vision_tpu_torch.accel import dense_isect as di
from vision_tpu_torch.accel import intersect as tisect
from vision_tpu_torch.core.types import Ray as TRay

torch.set_num_threads(2)

# t differs between XLA and eager torch only by op order / contraction on
# the CPU: 1e-5 relative, and 1e-7 absolute for t near 0 (a ray starting
# on a triangle), where the sum e2.qv cancels to its rounding error
T_RTOL = 1e-5
T_ATOL = 1e-7
UV_ATOL = 1e-5
# the K1 kernels' edge shapes: one ray, a chunk and one, a count that is
# no multiple of a pass (512 rays); no triangle, one, the resident limit
# (kTileTris, 512) and one past it, the dense path's limit and one past it
EDGE_R = (1, 33, 1000)
EDGE_T = (0, 1, 512, 513, 2048, 2049)
SMEM_MAX = 232448  # bytes of shared memory an H100 block may use


def _soup(n_tris, n_rays, seed):
    g = np.random.default_rng(seed)
    p0 = g.uniform(0.0, 1.0, (n_tris, 3)).astype(np.float32)
    e1 = g.uniform(-0.2, 0.2, (n_tris, 3)).astype(np.float32)
    e2 = g.uniform(-0.2, 0.2, (n_tris, 3)).astype(np.float32)
    o = g.uniform(0.0, 1.0, (n_rays, 3)).astype(np.float32)
    d = g.normal(size=(n_rays, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    tmax = g.uniform(0.05, 1.5, n_rays).astype(np.float32)
    return p0, e1, e2, o, d, tmax


def _quad_grid(n=8):
    """A z=0 grid of 2n^2 triangles with shared edges, and rays down onto it
    through its vertices and edges (exact-t ties between neighbours), or at
    random points, some beside the grid."""
    xs = np.linspace(0.0, 1.0, n + 1, dtype=np.float32)
    p0, e1, e2 = [], [], []
    for i in range(n):
        for j in range(n):
            a = np.array([xs[i], xs[j], 0], np.float32)
            b = np.array([xs[i + 1], xs[j], 0], np.float32)
            c = np.array([xs[i], xs[j + 1], 0], np.float32)
            dd = np.array([xs[i + 1], xs[j + 1], 0], np.float32)
            p0 += [a, b]
            e1 += [b - a, dd - b]
            e2 += [c - a, c - b]
    g = np.random.default_rng(3)
    k = 2048
    xy = np.concatenate([g.choice(xs, (k // 2, 2)),
                         g.uniform(-0.2, 1.2, (k // 2, 2))]).astype(np.float32)
    o = np.concatenate([xy, np.ones((k, 1), np.float32)], 1)
    d = np.tile(np.array([[0, 0, -1]], np.float32), (k, 1))
    return (np.stack(p0), np.stack(e1), np.stack(e2), o, d,
            g.uniform(0.5, 1.5, k).astype(np.float32))


CASES = {"soup": lambda: _soup(300, 4096, 0), "grid": _quad_grid}


def _both(case):
    p0, e1, e2, o, d, tmax = CASES[case]()
    jr = JRay(origin=jnp.asarray(o), direction=jnp.asarray(d),
              t_max=jnp.asarray(tmax))
    tr = TRay(tt(o), tt(d), tt(tmax))
    return (p0, e1, e2), jr, tr


def test_mt_batch():
    p0, e1, e2, o, d, _ = _soup(96, 512, 1)
    ja = jisect._mt_batch(jnp.asarray(o), jnp.asarray(d), jnp.asarray(p0)[None],
                          jnp.asarray(e1)[None], jnp.asarray(e2)[None])
    tb = tisect._mt_batch(tt(o), tt(d), tt(p0)[None], tt(e1)[None],
                          tt(e2)[None])
    ok_a, ok_b = np.asarray(ja[3]), np_(tb[3])
    # a pair may flip only on a rounding-level boundary
    assert (ok_a != ok_b).mean() < 1e-3
    both = ok_a & ok_b
    for x, y in zip(ja[:3], tb[:3]):
        np.testing.assert_allclose(np_(y)[both], np.asarray(x)[both],
                                   rtol=T_RTOL, atol=UV_ATOL)


def _assert_hits_match(ha, t, pid, bary):
    ida, idb = np.asarray(ha.prim_id), np_(pid)
    ta, tb = np.asarray(ha.t), np_(t)
    same = ida == idb
    # ids agree up to exact-t ties (neighbours sharing the hit point)
    assert np.allclose(ta[~same], tb[~same], rtol=T_RTOL, atol=T_ATOL)
    assert (~same).mean() < 0.05
    np.testing.assert_allclose(tb, ta, rtol=T_RTOL, atol=T_ATOL)
    np.testing.assert_allclose(np_(bary)[same], np.asarray(ha.bary)[same],
                               atol=UV_ATOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_closest(case):
    (p0, e1, e2), jr, tr = _both(case)
    ha = jisect.intersect_brute(jr, jnp.asarray(p0), jnp.asarray(e1),
                                jnp.asarray(e2))
    hb = tisect.intersect_brute(tr, tt(p0), tt(e1), tt(e2))
    assert hb.prim_id.dtype == torch.int32
    assert (np_(hb.prim_id) >= 0).any() and (np_(hb.prim_id) < 0).any()
    _assert_hits_match(ha, hb.t, hb.prim_id, hb.bary)
    # the wrapper takes the plain version for CPU tensors
    tris = tt(np.concatenate([p0, e1, e2], 1))
    t, pid, bary = di.closest(tr.origin, tr.direction, tr.t_max, tris)
    assert torch.equal(t, hb.t) and torch.equal(pid, hb.prim_id)
    assert torch.equal(bary, hb.bary)


@pytest.mark.parametrize("case", sorted(CASES))
def test_occluded(case):
    (p0, e1, e2), jr, tr = _both(case)
    oa = np.asarray(jisect.occluded_brute(jr, jnp.asarray(p0), jnp.asarray(e1),
                                          jnp.asarray(e2)))
    ob = tisect.occluded_brute(tr, tt(p0), tt(e1), tt(e2))
    assert 0 < oa.mean() < 1
    # a flip only where the nearest hit sits at t_max to rounding
    hb = tisect.intersect_brute(TRay(tr.origin, tr.direction,
                                     torch.full_like(tr.t_max, 1e30)),
                                tt(p0), tt(e1), tt(e2))
    edge = np.abs(np_(hb.t) - np_(tr.t_max)) <= 1e-5 * np_(tr.t_max)
    assert np.array_equal(oa[~edge], np_(ob)[~edge])
    tris = tt(np.concatenate([p0, e1, e2], 1))
    assert torch.equal(di.anyhit(tr.origin, tr.direction, tr.t_max, tris), ob)


def test_recompute_bary():
    (p0, e1, e2), jr, tr = _both("soup")
    ha = jisect.intersect_brute(jr, jnp.asarray(p0), jnp.asarray(e1),
                                jnp.asarray(e2))
    uva = jisect.recompute_bary(jr, ha, jnp.asarray(p0), jnp.asarray(e1),
                                jnp.asarray(e2))
    uvb = tisect.recompute_bary(tr, tt(np.asarray(ha.prim_id)), tt(p0), tt(e1),
                                tt(e2))
    np.testing.assert_allclose(np_(uvb), np.asarray(uva), rtol=T_RTOL,
                               atol=UV_ATOL)


def test_vs_pallas_interpret():
    """The Pallas K1 (interpret mode) against the port's plain version, on
    lanes whose winner lies more than 1e-6 inside its triangle: the Pallas
    kernel tests edges strictly (ROADMAP fault C1), the port with the
    1e-6 slack."""
    from vision_tpu.accel.pallas_isect import intersect_pallas
    p0, e1, e2, o, d, tmax = _soup(40, 1024, 4)
    jr = JRay(origin=jnp.asarray(o), direction=jnp.asarray(d),
              t_max=jnp.asarray(tmax))
    tr = TRay(tt(o), tt(d), tt(tmax))
    hp = intersect_pallas(jr, jnp.asarray(p0), jnp.asarray(e1),
                          jnp.asarray(e2), interpret=True)
    hb = tisect.intersect_brute(tr, tt(p0), tt(e1), tt(e2))
    uv = np_(hb.bary)
    inner = np.minimum(np.minimum(uv[:, 0], uv[:, 1]),
                       1.0 - uv[:, 0] - uv[:, 1]) > 1e-6
    keep = inner | (np_(hb.prim_id) < 0)
    assert keep.mean() > 0.99 and (np_(hb.prim_id)[keep] >= 0).any()
    assert np.array_equal(np.asarray(hp.prim_id)[keep], np_(hb.prim_id)[keep])
    np.testing.assert_allclose(np_(hb.t)[keep], np.asarray(hp.t)[keep],
                               rtol=T_RTOL, atol=T_ATOL)
    np.testing.assert_allclose(uv[keep], np.asarray(hp.bary)[keep],
                               atol=UV_ATOL)
    occ_p = np.asarray(intersect_pallas(jr, jnp.asarray(p0), jnp.asarray(e1),
                                        jnp.asarray(e2), any_hit=True,
                                        interpret=True).prim_id) >= 0
    occ_b = np_(tisect.occluded_brute(tr, tt(p0), tt(e1), tt(e2)))
    # strict edges only remove hits: the port occludes a superset
    assert not (occ_p & ~occ_b).any()
    assert (occ_b & ~occ_p).mean() < 0.01


def test_wrapper_rejects_other_devices():
    """A wrapper takes the plain version only for CPU tensors."""
    o = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match="want cuda or cpu"):
        di.closest(o, o, torch.zeros(4, device="meta"),
                   torch.zeros((2, 9), device="meta"))
    with pytest.raises(ValueError, match="want cuda or cpu"):
        di.anyhit(o, o, torch.zeros(4, device="meta"),
                  torch.zeros((2, 9), device="meta"))


def _dead_soup(n_tris, n_rays, seed):
    """_soup with every third ray dead (t_max 0) and one NaN t_max."""
    p0, e1, e2, o, d, tmax = _soup(n_tris, n_rays, seed)
    tmax[::3] = 0.0
    tmax[n_rays // 2] = np.nan
    return np.concatenate([p0, e1, e2], 1), o, d, tmax


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """K1's CUDA kernels against their plain versions on the card: 65,536
    rays over 2048 triangles, and every edge shape with dead rays."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    shapes = [(2048, 65536)] + [(T, R) for T in EDGE_T + (261156,)
                                for R in EDGE_R]
    for n_tris, n_rays in shapes:
        tris, o, d, tmax = _dead_soup(n_tris, n_rays, 5)
        if n_tris == 2048 and n_rays == 65536:
            tmax[:] = np.abs(tmax) + 0.05  # all live, as before
        cu = [torch.as_tensor(a, device="cuda") for a in (o, d, tmax)]
        tris = torch.as_tensor(tris, device="cuda")
        n0 = dict(di.LAUNCHES)
        t, pid, bary = di.closest(*cu, tris)
        tp, pidp, baryp = di.closest_plain(*cu, tris)
        same = pid == pidp
        assert same.float().mean() > 1 - 1e-4
        assert torch.allclose(t[~same], tp[~same], rtol=1e-6)
        assert torch.allclose(t, tp, rtol=1e-6, equal_nan=True)
        assert torch.allclose(bary[same], baryp[same], atol=1e-5)
        occ = di.anyhit(*cu, tris)
        occp = di.anyhit_plain(*cu, tris)
        assert (occ != occp).float().mean() <= 1e-4
        assert di.LAUNCHES["closest"] == n0["closest"] + 1
        assert di.LAUNCHES["anyhit"] == n0["anyhit"] + 1


@pytest.mark.parametrize("n_rays", EDGE_R)
@pytest.mark.parametrize("n_tris", EDGE_T)
def test_sweep_model_matches_plain(n_tris, n_rays):
    """The numpy model of the kernels' loop order (persistent blocks, dead
    rays answered and live ones packed, resident or tiled triangles, the
    any-hit vote every kChunk triangles) equals the plain versions bit for
    bit, writes every ray once and asks for at most 227 KB of shared
    memory."""
    tris, o, d, tmax = _dead_soup(n_tris, n_rays, n_tris + n_rays)
    m = sm.sweep(o, d, tmax, tris, resident=3)
    a = sm.sweep(o, d, tmax, tris, any_hit=True, resident=3)
    t, pid, bary = di.closest(tt(o), tt(d), tt(tmax), tt(tris))
    np.testing.assert_array_equal(m["t"], np_(t))
    np.testing.assert_array_equal(m["id"], np_(pid))
    np.testing.assert_array_equal(m["uv"], np_(bary))
    np.testing.assert_array_equal(
        a["occ"], np_(di.anyhit(tt(o), tt(d), tt(tmax), tt(tris))))
    assert (m["cover"] == 1).all() and (a["cover"] == 1).all()
    assert m["smem"] == 48 * min(n_tris, sm.constants()["kTileTris"])
    assert m["smem"] <= SMEM_MAX


@pytest.mark.parametrize("resident", (1, 3, 396))
@pytest.mark.parametrize("n_rays", EDGE_R + (262144 + 17,))
def test_sweep_model_covers_each_ray_once(n_rays, resident):
    """Every ray is written exactly once, dead or live, for any grid: one
    block taking many passes, a few, or one block per chunk."""
    g = np.random.default_rng(n_rays)
    tmax = np.where(g.random(n_rays) < 0.5, 0.0, 1.0).astype(np.float32)
    z = np.zeros((n_rays, 3), np.float32)
    res = sm.sweep(z, z, tmax, np.zeros((0, 9), np.float32), resident=resident)
    assert (res["cover"] == 1).all()
    assert res["blocks"] == min(resident, (n_rays + 31) // 32)
    np.testing.assert_array_equal(res["t"], tmax)
    assert (res["id"] == -1).all() and (res["uv"] == 0).all()


def test_sweep_model_vs_jax():
    """The model against the JAX package's intersect_brute /
    occluded_brute and the Pallas K1 in interpret mode, with dead rays
    (the Pallas kernel tests edges strictly, ROADMAP fault C1: compared on
    lanes whose winner lies more than 1e-6 inside its triangle)."""
    from vision_tpu.accel.pallas_isect import intersect_pallas
    tris, o, d, tmax = _dead_soup(40, 1024, 4)
    tmax[1024 // 2] = 0.0  # JAX's kernels take no NaN t_max
    jr = JRay(origin=jnp.asarray(o), direction=jnp.asarray(d),
              t_max=jnp.asarray(tmax))
    jt = [jnp.asarray(tris[:, k:k + 3]) for k in (0, 3, 6)]
    m = sm.sweep(o, d, tmax, tris, resident=2)
    a = sm.sweep(o, d, tmax, tris, any_hit=True, resident=2)
    _assert_hits_match(jisect.intersect_brute(jr, *jt), tt(m["t"]),
                       tt(m["id"]), tt(m["uv"]))
    assert (m["id"][tmax == 0] == -1).all()
    oa = np.asarray(jisect.occluded_brute(jr, *jt))
    near = sm.sweep(o, d, np.full_like(tmax, 1e30), tris)["t"]
    edge = np.abs(near - tmax) <= 1e-5 * tmax
    assert np.array_equal(oa[~edge], a["occ"][~edge]) and 0 < oa.mean() < 1
    hp = intersect_pallas(jr, *jt, interpret=True)
    uv = m["uv"]
    inner = np.minimum(np.minimum(uv[:, 0], uv[:, 1]),
                       1.0 - uv[:, 0] - uv[:, 1]) > 1e-6
    keep = inner | (m["id"] < 0)
    assert keep.mean() > 0.99 and (m["id"][keep] >= 0).any()
    assert np.array_equal(np.asarray(hp.prim_id)[keep], m["id"][keep])
    np.testing.assert_allclose(m["t"][keep], np.asarray(hp.t)[keep],
                               rtol=T_RTOL, atol=T_ATOL)


def test_sweep_model_skips_dead_lanes():
    """Dead rays cost no lane-tests: with every other ray dead the warps
    issue exactly half the tests; an any-hit warp whose rays are all
    occluded by the first triangles leaves after one chunk of kChunk."""
    c = sm.constants()
    tris, o, d, tmax = _dead_soup(36, 4096, 7)
    tmax = np.abs(np.nan_to_num(tmax)) + 0.05
    half = tmax.copy()
    half[1::2] = 0.0
    full = sm.sweep(o, d, tmax, tris, resident=8)["lane_tests"]
    assert full == 4096 * 36
    assert sm.sweep(o, d, half, tris, resident=8)["lane_tests"] * 2 == full
    # a wall at z = 0.5 in front of rays going up from z = 0, first in id order
    wall = np.array([[-9, -9, 0.5, 30, 0, 0, 0, 30, 0]], np.float32)
    up = np.tile(np.array([[0, 0, 1]], np.float32), (4096, 1))
    o2 = o.copy()
    o2[:, 2] = 0.0
    res = sm.sweep(o2, up, tmax + 1.0, np.concatenate([wall, tris]),
                   any_hit=True, resident=8)
    assert res["occ"].all()
    assert res["lane_tests"] == 4096 * c["kChunk"]


def test_chip_smoke_k1_bound():
    """chip_smoke.py's bound of K1 at the cornell box's shape (262,144 rays
    x 36 triangles x 40 FLOP per test): 377,487,360 FLOP at 67 TFLOP/s is
    5.63 us, above the 11.5 MB of rays, triangles and results at 3.35 TB/s,
    so operations set it; a bytes-only load is bound by bytes."""
    import importlib.util
    import os
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_bounds", os.path.join(os.path.dirname(__file__), "..",
                                          "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    ops, nbytes = cs.k1_work(262144, 36, any_hit=False)
    assert ops == 377_487_360
    assert nbytes == 262144 * (12 + 12 + 4 + 4 + 4 + 8) + 36 * 36
    ms, by = cs.bound_ms(ops, nbytes)
    assert by == "operations" and round(ms * 1e3, 2) == 5.63
    assert cs.k1_work(262144, 36, any_hit=True)[1] == 262144 * 29 + 36 * 36
    # dead rays (t_max <= 0) cost a t_max read and a result, no tests
    ops, nbytes = cs.k1_work(262144, 36, any_hit=False, live=131072)
    assert ops == 131072 * 36 * 40
    assert nbytes == 262144 * (4 + 16) + 131072 * 24 + 36 * 36
    # an any-hit sweep that stops early counts the tests it needed
    assert cs.k1_work(262144, 36, any_hit=True, live=131072,
                      tests=1_000_000)[0] == 40_000_000
    ms, by = cs.bound_ms(0, 3.35e9)
    assert by == "bytes" and ms == pytest.approx(1.0)
