"""Parity of the port's instanced path (repeated meshes through kernel K3)
with the JAX package: the TLAS/BLAS tree, the plain K3 walk
(`intersect_packet_inst_plain`) on the very same tree as the JAX Pallas K3
(interpret mode), the instanced scene's loader and surface interaction, and
the instanced scene against its flat twin (VT_INSTANCING=0) through
`radiance`. The CUDA kernels are held against the plain walk on the card
(chip_smoke.py, and the `cuda`-marked test here)."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vision_tpu_torch as vt
from tests import torch_walk_model as wm
from tests.torch_parity import jax_scene_arrays, np_, tt
from tests.torch_scenes import cbox_spheres_instanced
from vision_tpu.accel import packet_bvh as jpb
from vision_tpu.core.types import Ray as JRay
from vision_tpu.integrator import pt as jpt
from vision_tpu.scene.scene import Scene as JScene
from vision_tpu_torch.accel import packet_bvh as tpb
from vision_tpu_torch.accel import packet_isect as pi
from vision_tpu_torch.core import rng as trng
from vision_tpu_torch.core.types import Hit
from vision_tpu_torch.integrator import pt as tpt
from vision_tpu_torch.scene import shapes as tshp
from vision_tpu_torch.scene.scene import scene_from_arrays

torch.set_num_threads(2)

T_RTOL = 1e-5  # t between XLA and eager torch (op order)
# u, v after the ray's move to object space: XLA and eager torch round the
# transform's multiply-adds differently, and u, v divide that by the size
# of a small triangle (~0.05 here)
UV_ATOL = 1e-4
RES = 24


@pytest.fixture(scope="module")
def scenes():
    """16 instances (every other one turned about y) of a 960-tri sphere at
    24^2: both packages, the JAX scene carried across, and the flat twin."""
    s = cbox_spheres_instanced(RES, sub_div=16)
    js = JScene(s)
    carried = scene_from_arrays(jax_scene_arrays(js), "cpu")
    return s, js, carried, vt.load_scene(s, device="cpu")


def _rays(js, n_extra=448, seed=0):
    """The camera's pixel-centre rays plus seeded rays from inside the box."""
    R = RES * RES
    pix = np.arange(R)
    p = np.stack([pix % RES + 0.5, pix // RES + 0.5], -1).astype(np.float32)
    cam = js.camera.generate_ray(jnp.asarray(p), jnp.zeros((R, 2)))
    g = np.random.default_rng(seed)
    o = g.uniform([-0.9, 0.1, -0.9], [0.9, 1.9, 0.9], (n_extra, 3))
    d = g.normal(size=(n_extra, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.concatenate([np.asarray(cam.origin), o]).astype(np.float32)
    d = np.concatenate([np.asarray(cam.direction), d]).astype(np.float32)
    return o, d


def test_build_matches_jax():
    """The same meshes and instances at the same leaf size give the JAX
    package's TLAS/BLAS arrays, field for field."""
    sph = tshp.make_sphere(0.6, 16)
    tri = sph.triangles
    mesh = tuple(sph.positions[tri[:, k]] for k in range(3))
    quad = tshp.make_quad(2.0, 2.0)
    qmesh = tuple(quad.positions[quad.triangles[:, k]] for k in range(3))
    c, s = math.cos(0.6), math.sin(0.6)
    insts = [(0, np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0],
                           [-2.0 + 1.4 * i, 0.8, 1.0 + 0.2 * i, 1]], float))
             for i in range(3)]
    insts[1][1][:3, :3] = [[c, 0, -s], [0, 1, 0], [s, 0, c]]
    insts.append((1, np.eye(4)))
    a = tpb.build_instanced_pbvh([mesh, qmesh], insts, "cpu", bsize=64)
    b = jpb.build_instanced_pbvh([mesh, qmesh], insts)
    assert a.bsize == b.bsize
    for k in ("skip", "brick", "prim_order", "inst_root"):
        np.testing.assert_array_equal(np_(getattr(a, k)), np.asarray(getattr(b, k)))
    for k in ("lo", "hi"):
        np.testing.assert_array_equal(
            np_(getattr(a, k)),
            np.stack([np.asarray(getattr(b, f"{k}_{c}")) for c in "xyz"], -1))
    np.testing.assert_array_equal(np_(a.tri), np.asarray(b.tri)[:, :9])
    np.testing.assert_array_equal(np_(a.inst_w2o).reshape(-1),
                                  np.asarray(b.inst_w2o))
    assert 0 < a.depth <= tpb.STACK and a.max_steps > a.n_nodes
    # the kernels' layout: records (a header per tree), instance records
    assert np_(a.heads).shape == (3,) and np_(a.insts).shape == (4, 16)
    wm.check_records(a)


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "anyhit"])
def test_plain_matches_jax(scenes, any_hit):
    """The plain K3 on the carried-across JAX tree against the Pallas K3 in
    interpret mode: ids and instances equal up to exact-t ties."""
    _, js, (data, _, _), _ = scenes
    o, d = _rays(js)
    R = len(o)
    tmax = np.where(np.arange(R) % 2 == 0, 1e30, 1.5).astype(np.float32)
    jr = JRay(origin=jnp.asarray(o), direction=jnp.asarray(d),
              t_max=jnp.asarray(tmax))
    hj, ij = jpb.intersect_packet_inst(jr, js.data.ipbvh, any_hit=any_hit,
                                       interpret=True)
    if any_hit:
        occ = np_(tpb.intersect_packet_inst_plain(tt(o), tt(d), tt(tmax),
                                                  data.ipbvh, any_hit=True))
        assert np.array_equal(occ, np.asarray(hj.prim_id) >= 0)
        assert occ.any() and not occ.all()
        return
    t, pid, uv, inst = tpb.intersect_packet_inst_plain(tt(o), tt(d), tt(tmax),
                                                       data.ipbvh)
    t, pid, uv, inst = (np_(x) for x in (t, pid, uv, inst))
    ta, ia, ja = (np.asarray(x) for x in (hj.t, hj.prim_id, ij))
    diff = (pid != ia) | (inst != ja)
    assert (np.abs(t - ta) <= T_RTOL * np.abs(ta))[diff].all()
    assert diff.mean() <= 1e-3, diff.sum()
    np.testing.assert_allclose(t, ta, rtol=T_RTOL)
    np.testing.assert_allclose(uv[~diff], np.asarray(hj.bary)[~diff],
                               atol=UV_ATOL)
    hit_inst = set(inst[inst >= 0].tolist())
    assert len(hit_inst) > 8 and (pid < 0).any()


@pytest.mark.parametrize("tree", ["port", "jax"])
def test_records_hold_the_tree(scenes, tree):
    """The instanced scene's records (the port's own tree at leaf 4 and the
    JAX tree carried across) hold the TLAS and every mesh tree."""
    data = scenes[3].data if tree == "port" else scenes[2][0]
    wm.check_records(data.ipbvh)


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "anyhit"])
def test_kernel_walk_model_matches_plain(scenes, any_hit):
    """The kernels' walk over the records (the numpy model: instance enter
    and leave on one stack) against the plain K3 bit for bit, on the
    rotated instances: 2,048 rays with every 7th lane dead."""
    _, js, _, ps = scenes
    ip = ps.data.ipbvh
    o, d = _rays(js, n_extra=2048 - RES * RES, seed=3)
    R = len(o)
    tmax = np.where(np.arange(R) % 7 == 0, 0.0, 1e30).astype(np.float32)
    args = (np_(ip.nodes), np_(ip.tris), ip.bsize, np_(ip.insts))
    plain = tpb.intersect_packet_inst_plain(tt(o), tt(d), tt(tmax), ip)
    if any_hit:
        t, pid = np_(plain[0]), np_(plain[1])
        tmax = np.where(pid >= 0, t * 1.01, 2.0).astype(np.float32)
        tmax[::7] = 0.0
        occ, _ = wm.walk(o, d, tmax, *args, any_hit=True)
        occ_p = np_(tpb.intersect_packet_inst_plain(tt(o), tt(d), tt(tmax),
                                                    ip, any_hit=True))
        assert np.array_equal(occ, occ_p) and occ.any() and not occ.all()
        return
    model, counts = wm.walk(o, d, tmax, *args)
    for a, b in zip(model, plain):
        assert np.array_equal(a, np_(b))
    assert len(set(model[3][model[3] >= 0].tolist())) > 8
    assert (model[1][::7] == -1).all()
    assert counts[:, 4].max() >= 2 and counts[:, 5].max() <= ip.depth


def test_loader_matches_jax(scenes):
    """The port's own load of the instanced scene gives the JAX package's
    tables: rows [unique mesh in object space][residual], instance maps,
    transforms and the light tables whose tri_base starts after the mesh."""
    _, js, _, ps = scenes
    d = ps.data
    assert d.ipbvh is not None and d.pbvh is None and d.ipbvh.n_inst == 17
    ref = jax_scene_arrays(js)
    for k in ("tri_pack", "inst_mat", "inst_light", "inst_scene",
              "inst_xform"):
        np.testing.assert_array_equal(np_(getattr(d, k)), ref[k])
    for k in ("tri_base", "tri_offset", "tri_count", "inst_id", "a_prob",
              "a_alias", "total_area"):
        np.testing.assert_array_equal(np_(getattr(d.lights, k)),
                                      ref[f"lights.{k}"])
    assert d.world_radius == float(ref["world_radius"])
    # the light quad follows the sphere mesh and the 34 other residual tris
    assert int(np_(d.lights.tri_base)[0]) == 960 + 34


def test_compute_interaction(scenes):
    """Surface interaction from the same instanced hits in both packages
    (object-space rows moved to world space by the hit instance)."""
    _, js, (data, _, _), _ = scenes
    o, d = _rays(js, seed=1)
    jr = JRay.make(jnp.asarray(o), jnp.asarray(d))
    hj = jpt.trace_closest(js.data, jr)
    assert hj.inst is not None and (np.asarray(hj.inst) >= 0).any()
    th = Hit(t=tt(hj.t), prim_id=tt(hj.prim_id), bary=tt(hj.bary),
             inst=tt(hj.inst))
    a = jpt.compute_interaction(js.data, jr, hj)
    b = tpt.compute_interaction(data, th)
    for x, y in zip(a, b):
        np.testing.assert_allclose(np_(y), np.asarray(x), rtol=1e-5, atol=1e-5)


def test_matches_flat_twin(scenes, monkeypatch):
    """The port's instanced scene against its flat twin (VT_INSTANCING=0)
    through radiance at depth 3, the same rays and RNG states: at most 2%
    of lanes differ and the means agree within 2% (rounding in object
    space moves hits at edges), as tests/test_instancing.py holds the JAX
    package."""
    s, _, _, ps = scenes
    monkeypatch.setenv("VT_INSTANCING", "0")
    flat = vt.load_scene(s, device="cpu")
    assert flat.data.ipbvh is None and flat.data.pbvh is not None
    assert flat.data.tri_pack.shape[0] == 16 * 960 + 36
    R = RES * RES
    pix = torch.arange(R)
    p = torch.stack([(pix % RES).float() + 0.5, (pix // RES).float() + 0.5], -1)
    ray = ps.camera.generate_ray(p, torch.zeros_like(p))
    st = trng.seed(pix, 0)
    La, _ = tpt.radiance(ps.data, ray, st, max_depth=3)
    Lb, _ = tpt.radiance(flat.data, ray, st, max_depth=3)
    a, b = np_(La), np_(Lb)
    bad = (np.abs(a - b) > 1e-3 + 1e-3 * np.abs(b)).any(-1)
    assert bad.mean() < 0.02, bad.sum()
    assert np.allclose(a.mean(0), b.mean(0), rtol=0.02, atol=1e-3)


def test_wrapper_rejects_other_devices(scenes):
    ip = scenes[3].data.ipbvh
    o = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match="want cuda or cpu"):
        pi.closest_inst(o, o, torch.zeros(4, device="meta"), ip)
    with pytest.raises(ValueError, match="want cuda or cpu"):
        pi.anyhit_inst(o, o, torch.zeros(4, device="meta"), ip)


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """K3's CUDA kernels against the plain walk on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    ps = vt.load_scene(cbox_spheres_instanced(128, sub_div=32), device="cuda")
    ip = ps.data.ipbvh
    R = 128 * 128
    pix = torch.arange(R, device="cuda")
    p = torch.stack([(pix % 128).float() + 0.5, (pix // 128).float() + 0.5], -1)
    ray = ps.camera.generate_ray(p, torch.zeros_like(p))
    o, d = ray.origin.contiguous(), ray.direction.contiguous()
    tmax = torch.full((R,), 1e30, device="cuda")
    t, pid, uv, inst = pi.closest_inst(o, d, tmax, ip)
    tp, pidp, uvp, instp = tpb.intersect_packet_inst_plain(o, d, tmax, ip)
    same = (pid == pidp) & (inst == instp)
    assert same.float().mean() > 1 - 1e-4
    assert torch.allclose(t, tp, rtol=1e-6)
    tmax = torch.where(pidp >= 0, tp * 1.2, 2.0)
    occ = pi.anyhit_inst(o, d, tmax, ip)
    assert (occ != tpb.intersect_packet_inst_plain(o, d, tmax, ip, any_hit=True)
            ).float().mean() <= 1e-4
