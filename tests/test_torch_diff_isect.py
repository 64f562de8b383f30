"""The hit-gradient contract of the port's traversal.

K1's closest hit carries a gradient (`dense_isect._Closest`): its backward
is the vector-Jacobian product of the winner's Möller-Trumbore t and
(u, v) with respect to origin, direction and t_max, which is what autograd
through the plain sweep gives and what the JAX package's CPU route
(`intersect_brute` + `recompute_bary`) gives; a miss passes t's gradient
to t_max. At an exact tie of t between triangles of two planes (a ray
through a corner of the box) the JAX package's `jnp.min` splits t's
gradient between the tied triangles; the port takes the winner's (the
lower id), as autograd through torch.min does: both are subgradients at
the kink, and t's gradient reaches an image only through media (the hit
point comes from (u, v)). The any hit is a boolean. K2 / K3 hits are
constants, as the JAX package's packet path makes them. A render without
grad dispatches no more operations than before the Function existed."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import vision_tpu_torch as vt
from tests.test_torch_isect import _quad_grid
from tests.torch_parity import cbox, np_, tt
from tests.torch_scenes import cbox_sphere, cbox_spheres_instanced
from vision_tpu.accel import intersect as jisect
from vision_tpu.core.types import Ray as JRay
from vision_tpu_torch.accel import dense_isect as di
from vision_tpu_torch.accel import packet_isect as pi
from vision_tpu_torch.integrator import pt as tpt

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def cbox_scene():
    return vt.load_scene(cbox(32), device="cpu")


def _wavefront(sc, kind):
    """(origin, direction, t_max, tris) numpy: the cbox's primary rays at
    pixel centres, a bounce from their hits in seeded directions (with
    misses through the open front), or the quad grid's edge and vertex
    rays."""
    if kind == "grid":
        p0, e1, e2, o, d, tmax = _quad_grid()
        return o, d, tmax, np.concatenate([p0, e1, e2], 1)
    W, H = sc.camera.resolution
    pix = torch.arange(W * H)
    p = torch.stack([(pix % W).float() + 0.5, (pix // W).float() + 0.5], -1)
    ray = sc.camera.generate_ray(p)
    tris = sc.data.tri_geom
    o, d = np_(ray.origin), np_(ray.direction)
    tmax = np.full(len(o), 1e30, np.float32)
    if kind == "bounce":
        t, _, _ = di.closest_plain(ray.origin, ray.direction, ray.t_max, tris)
        o = o + d * (np_(t)[:, None] * 0.999)
        g = np.random.default_rng(5).normal(size=o.shape)
        d = (g / np.linalg.norm(g, axis=-1, keepdims=True)).astype(np.float32)
        tmax = np.random.default_rng(6).uniform(0.2, 4.0, len(o)).astype(
            np.float32)
    return o.astype(np.float32), d, tmax, np_(tris)


def _grads(fn, o, d, tmax, tris, g_t, g_b):
    x = [tt(a).requires_grad_(True) for a in (o, d, tmax)]
    t, pid, bary = fn(*x, tt(tris))
    gs = torch.autograd.grad((t, bary), x, (tt(g_t), tt(g_b)))
    return [np_(v) for v in (t, pid, bary)], [np_(g) for g in gs]


@pytest.mark.parametrize("kind", ["primary", "bounce", "grid"])
def test_function_matches_plain_autograd_and_jax(cbox_scene, kind):
    """The Function's backward against autograd through `closest_plain`
    and against `jax.vjp` of the JAX package's `intersect_brute`, with
    seeded cotangents for t and (u, v), the latter on the rays without an
    exact tie of t between two triangles (at most 4%: at 32^2 the pixel
    centres on the image's diagonals look exactly into the box's corner
    edges, 32 of 1024 rays; the grid's ties lie in one plane, where the
    tied triangles' t have one gradient, so every ray is held); its
    forward is the plain sweep's bit for bit."""
    o, d, tmax, tris = _wavefront(cbox_scene, kind)
    g = np.random.default_rng(1)
    g_t = g.standard_normal(len(o)).astype(np.float32)
    g_b = g.standard_normal((len(o), 2)).astype(np.float32)
    (t, pid, bary), ga = _grads(di.closest, o, d, tmax, tris, g_t, g_b)
    (t2, pid2, bary2), gp = _grads(di.closest_plain, o, d, tmax, tris, g_t,
                                   g_b)
    assert np.array_equal(t, t2) and np.array_equal(pid, pid2)
    assert np.array_equal(bary, bary2)
    assert (pid >= 0).mean() > 0.3
    if kind == "bounce":
        assert (pid < 0).sum() > 10   # misses send t's gradient to t_max
        assert np.abs(ga[2][pid < 0]).max() > 0.0
    for a, b in zip(ga, gp):
        np.testing.assert_allclose(a, b, rtol=1e-5,
                                   atol=1e-5 * np.abs(b).max())

    def f(o_, d_, tm_):
        h = jisect.intersect_brute(JRay(o_, d_, tm_), jnp.asarray(tris[:, :3]),
                                   jnp.asarray(tris[:, 3:6]),
                                   jnp.asarray(tris[:, 6:]))
        return h.t, h.bary

    _, vjp = jax.vjp(f, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax))
    gj = vjp((jnp.asarray(g_t), jnp.asarray(g_b)))
    tie = _ties(o, d, tris, t) & (kind != "grid")
    assert tie.mean() <= 0.04, tie.sum()
    for a, b in zip(ga, gj):
        b = np.asarray(b)[~tie]
        np.testing.assert_allclose(a[~tie], b, rtol=1e-4,
                                   atol=1e-4 * np.abs(b).max())


def _ties(o, d, tris, t):
    """Rays whose closest t is reached by two or more triangles."""
    from vision_tpu_torch.accel import intersect as ti
    tv, _, _, ok = ti._mt_batch(tt(o), tt(d), tt(tris[None, :, :3]),
                                tt(tris[None, :, 3:6]), tt(tris[None, :, 6:]))
    return ((np_(tv) == t[:, None]) & np_(ok)).sum(-1) > 1


def test_anyhit_and_gradless_calls_carry_no_graph(cbox_scene):
    """The any hit is a boolean; a closest hit of rays that do not require
    grad (a render without grad) takes no Function and makes no graph."""
    o, d, tmax, tris = _wavefront(cbox_scene, "bounce")
    x = [tt(a).requires_grad_(True) for a in (o, d, tmax)]
    occ = di.anyhit(*x, tt(tris))
    assert occ.dtype == torch.bool and not occ.requires_grad
    t, _, bary = di.closest(tt(o), tt(d), tt(tmax), tt(tris))
    assert t.grad_fn is None and bary.grad_fn is None
    with torch.no_grad():
        t, _, _ = di.closest(*x, tt(tris))
    assert t.grad_fn is None


def test_function_without_triangles():
    """With no triangle every ray misses: t = t_max carries its gradient
    to t_max, and nothing reaches the origin or the direction."""
    x = [torch.rand(5, 3, requires_grad=True),
         torch.randn(5, 3, requires_grad=True),
         torch.full((5,), 1e30, requires_grad=True)]
    t, pid, bary = di.closest(*x, torch.zeros((0, 9)))
    assert (pid < 0).all()
    go, gd, gt = torch.autograd.grad(t.sum() + bary.sum(), x)
    assert not go.any() and not gd.any() and torch.equal(gt, torch.ones(5))


@pytest.fixture(scope="module")
def bvh_scenes():
    return {"K2": vt.load_scene(cbox_sphere(8, sub_div=40), device="cpu"),
            "K3": vt.load_scene(cbox_spheres_instanced(8, sub_div=16),
                                device="cpu")}


@pytest.mark.parametrize("kernel", ["K2", "K3"])
def test_bvh_hits_are_constants(bvh_scenes, kernel):
    """K2 / K3 outputs do not require grad even when the rays do (the JAX
    package's packet path stops the gradient at every kernel input)."""
    sc = bvh_scenes[kernel]
    ray = sc.camera.generate_ray(torch.rand(64, 2) * 8.0)
    o = ray.origin.clone().requires_grad_(True)
    d = ray.direction.clone().requires_grad_(True)
    tmax = ray.t_max.clone().requires_grad_(True)
    if kernel == "K2":
        outs = pi.closest(o, d, tmax, sc.data.pbvh)
        occ = pi.anyhit(o, d, tmax, sc.data.pbvh)
    else:
        outs = pi.closest_inst(o, d, tmax, sc.data.ipbvh)
        occ = pi.anyhit_inst(o, d, tmax, sc.data.ipbvh)
    assert (outs[1] >= 0).any()
    assert not any(x.requires_grad for x in outs + (occ,))


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


# dispatched operations of the render below before the K1 Function existed
# (26,931 in its 22 iterations)
OPS_BEFORE = 26931


def test_render_without_grad_dispatches_no_more_ops():
    """A no-grad render of the cbox (16^2, 4 spp, frame 0) dispatches no
    more operations than on the tree before gradients were ported."""
    sc = vt.load_scene(cbox(16), device="cpu")
    with _CountOps() as c:
        _, aov = tpt.render_wave(sc.data, sc.camera, sc.filter, 0, 4,
                                 sc.max_depth, sc.min_depth, sc.rr_threshold)
    assert aov["iters"] == 22
    assert c.n <= OPS_BEFORE, c.n


@pytest.mark.cuda
def test_function_on_card_matches_plain_autograd():
    """On the card: the Function (the kernel's forward, torch backward)
    against autograd through `closest_plain`, on the cbox's primary rays."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    sc = vt.load_scene(cbox(64), device="cuda")
    o, d, tmax, tris = _wavefront(sc, "primary")
    g = np.random.default_rng(1)
    cot = (torch.as_tensor(g.standard_normal(len(o)), dtype=torch.float32,
                           device="cuda"),
           torch.as_tensor(g.standard_normal((len(o), 2)), dtype=torch.float32,
                           device="cuda"))
    out = []
    for fn in (di.closest, di.closest_plain):
        x = [torch.as_tensor(a, device="cuda").requires_grad_(True)
             for a in (o, d, tmax)]
        t, _, bary = fn(*x, torch.as_tensor(tris, device="cuda"))
        out.append(torch.autograd.grad((t, bary), x, cot))
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, rtol=1e-5,
                                   atol=1e-5 * float(b.abs().max()))
