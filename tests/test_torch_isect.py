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


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """K1's CUDA kernels against their plain versions on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    p0, e1, e2, o, d, tmax = _soup(2048, 65536, 5)
    cu = [torch.as_tensor(a, device="cuda") for a in (o, d, tmax)]
    tris = torch.as_tensor(np.concatenate([p0, e1, e2], 1), device="cuda")
    n0 = dict(di.LAUNCHES)
    t, pid, bary = di.closest(*cu, tris)
    tp, pidp, baryp = di.closest_plain(*cu, tris)
    same = pid == pidp
    assert same.float().mean() > 1 - 1e-4
    assert torch.allclose(t[~same], tp[~same], rtol=1e-6)
    assert torch.allclose(t, tp, rtol=1e-6)
    assert torch.allclose(bary[same], baryp[same], atol=1e-5)
    occ = di.anyhit(*cu, tris)
    occp = di.anyhit_plain(*cu, tris)
    assert (occ != occp).float().mean() <= 1e-4
    assert di.LAUNCHES["closest"] == n0["closest"] + 1
    assert di.LAUNCHES["anyhit"] == n0["anyhit"] + 1


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
    ms, by = cs.bound_ms(0, 3.35e9)
    assert by == "bytes" and ms == pytest.approx(1.0)
