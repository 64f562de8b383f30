"""Shared helpers of the parity tests between `vision_tpu` (JAX, the
reference) and `vision_tpu_torch` (the PyTorch port): data passes between
the two packages as numpy arrays."""
import copy
import dataclasses

import numpy as np
import torch

from tests.fixtures import CBOX_JSON


def cbox(res, **changes):
    """A copy of CBOX_JSON at res x res."""
    s = copy.deepcopy(CBOX_JSON)
    s["camera"]["param"]["radiance_collector"]["param"]["resolution"] = [res, res]
    s.update(changes)
    return s


def _record_arrays(obj, prefix):
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if v is None or dataclasses.is_dataclass(v):
            continue
        out[prefix + f.name] = np.asarray(v)
    return out


def jax_scene_arrays(scene):
    """The JAX scene state, every field as np.asarray, keyed as
    `vision_tpu_torch.scene.scene.scene_from_arrays` reads it."""
    d = scene.data
    arrays = _record_arrays(d, "")
    for name in ("materials", "mediums", "lights", "atlas", "spectrum", "pbvh",
                 "ipbvh"):
        if getattr(d, name) is not None:
            arrays.update(_record_arrays(getattr(d, name), name + "."))
    arrays.update(_record_arrays(scene.camera, "camera."))
    arrays.update(_record_arrays(scene.filter, "filter."))
    return arrays


def tt(a, dtype=None):
    """numpy / jax array -> CPU torch tensor."""
    return torch.as_tensor(np.array(a), dtype=dtype)


def np_(x):
    """torch tensor or jax array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def block_err(a, b, B=8):
    """8x8 block-averaged weighted error and relative bias of image a
    against b (the measure of tests/test_golden.py
    test_cbox_hdr_self_golden)."""
    H, W, _ = a.shape
    ab = a.reshape(H // B, B, W // B, B, 3).mean((1, 3))
    bb = b.reshape(H // B, B, W // B, B, 3).mean((1, 3))
    return np.abs(ab - bb).sum() / bb.sum(), (ab - bb).mean() / bb.mean()


def mostly_close(y, x, rtol, atol, loose, share=0.01):
    """y within (rtol, atol) of x on all but `share` of the rows (leading
    axis), and every element within `loose` (relative and absolute): for
    outputs where float32 rounding in another op order meets an
    ill-conditioned step (a square root or arccos near 0 / 1, a peaked
    lobe) on a few lanes."""
    x, y = np.asarray(x), np_(y)
    off = ~np.isclose(y, x, rtol=rtol, atol=atol)
    off = off.reshape(off.shape[0], -1).any(-1)
    assert off.mean() <= share, off.sum()
    np.testing.assert_allclose(y, x, rtol=loose, atol=loose)


def _rays_and_states(res, seed):
    """Jittered film positions [R, 2] and per-lane RNG seeds [R] from a
    numpy seed, and the generator for what follows."""
    R = res * res
    g = np.random.default_rng(seed)
    p_film = (np.stack([np.arange(R) % res, np.arange(R) // res], -1)
              + g.random((R, 2))).astype(np.float32)
    seeds = g.integers(0, 2 ** 32, R, dtype=np.uint64)
    return p_film, seeds, g


def radiance_both(js, ps, res, max_depth=3, rr_threshold=1.0, seed=0,
                  include_primary=True):
    """Per-lane `radiance` of both packages (JAX jitted, the port's plain
    path) on the same jittered camera rays and RNG states from a numpy
    seed. Returns (La, aovs_a, Lb, aovs_b) as numpy / dicts."""
    import jax
    import jax.numpy as jnp
    from vision_tpu.core import rng as jrng
    from vision_tpu.integrator import pt as jpt
    from vision_tpu_torch.core import rng as trng
    from vision_tpu_torch.integrator import pt as tpt
    R = res * res
    p_film, seeds, _ = _rays_and_states(res, seed)
    jray = js.camera.generate_ray(jnp.asarray(p_film))
    jst = jrng.seed(jnp.arange(R, dtype=jnp.uint32),
                    jnp.asarray(seeds.astype(np.uint32)))
    La, aa = jax.jit(lambda d, r, s: jpt.radiance(
        d, r, s, max_depth=max_depth, rr_threshold=rr_threshold,
        include_primary=include_primary))(js.data, jray, jst)
    Lb, ab = tpt.radiance(ps.data, ps.camera.generate_ray(tt(p_film)),
                          trng.seed(torch.arange(R), tt(seeds.astype(np.int64))),
                          max_depth=max_depth, rr_threshold=rr_threshold,
                          include_primary=include_primary)
    return np.asarray(La), aa, np_(Lb), ab


def port_record(jrec, cls, **static):
    """A JAX record (flax dataclass) as the port's dataclass `cls` on the
    CPU: each array field copied by name (a uint32 array as int64, the
    port's masked-uint32 layout), the fields in `static` as given."""
    out = dict(static)
    for f in dataclasses.fields(cls):
        if f.name in static:
            continue
        v = getattr(jrec, f.name)
        if v is None:
            out[f.name] = None
            continue
        a = np.array(v)
        out[f.name] = torch.as_tensor(a.astype(np.int64) if a.dtype == np.uint32
                                      else a)
    return cls(**out)


def radiance_vjp_both(js, params, res, max_depth=3, seed=0, share=0.01,
                      jit=False):
    """The vector-Jacobian product of per-lane `radiance` (no Russian
    roulette, each bounce checkpointed) with respect to `params`, a nested
    {group: [keys]} of the JAX package's `param_surface` groups, in both
    packages: the JAX package through `jax.vjp`, the port through torch
    autograd, on the same scene arrays (`scene_from_arrays`), the same
    parameters (`params_from_arrays`), jittered camera rays and RNG states,
    and a seeded-random cotangent [R, 3]. Lanes whose forward radiance
    differs past the per-lane tolerance of `assert_radiance_close` get a
    zero cotangent; at most `share` of them may. The JAX package runs op by
    op (`jax.disable_jit`), which on the lobe-rich scenes is several times
    quicker than compiling the whole backward, or with `jit` compiled once
    (quicker on the Lambert cbox). Returns (gradients of the JAX
    package, of the port, each {group: {key: numpy}}, forward radiance of
    both)."""
    import jax
    import jax.numpy as jnp
    from vision_tpu.core import rng as jrng
    from vision_tpu.diff import optimize as jopt
    from vision_tpu.integrator import pt as jpt
    from vision_tpu_torch.core import rng as trng
    from vision_tpu_torch.diff import optimize as topt
    from vision_tpu_torch.integrator import pt as tpt
    from vision_tpu_torch.scene.scene import scene_from_arrays
    R = res * res
    p_film, seeds, g = _rays_and_states(res, seed)
    cot = g.standard_normal((R, 3)).astype(np.float32)
    surface = jopt.param_surface(js.data, js.camera, tuple(params))
    jp = {grp: {k: surface[grp][k] for k in keys}
          for grp, keys in params.items()}
    jst = jrng.seed(jnp.arange(R, dtype=jnp.uint32),
                    jnp.asarray(seeds.astype(np.uint32)))

    def f(p):
        sc, cam = jopt.apply_params(js.data, js.camera, p)
        L, _ = jpt.radiance(sc, cam.generate_ray(jnp.asarray(p_film)), jst,
                            max_depth=max_depth, min_depth=99, remat=True)
        return L

    data, camera, _ = scene_from_arrays(jax_scene_arrays(js), "cpu")
    pp = topt.params_from_arrays(jax.tree.map(np.asarray, jp), "cpu")
    leaves = [(grp, k, v.requires_grad_(True))
              for grp, d in pp.items() for k, v in d.items()]
    sc, cam = topt.apply_params(data, camera, pp)
    Lb, _ = tpt.radiance(sc, cam.generate_ray(tt(p_film)),
                         trng.seed(torch.arange(R), tt(seeds.astype(np.int64))),
                         max_depth=max_depth, min_depth=99, remat=True)
    def bad_lanes(La):
        bad = (np.abs(La - np_(Lb)) > 1e-4 + 1e-3 * np.abs(La)).any(-1)
        assert bad.mean() <= share, bad.sum()
        return bad

    if jit:
        @jax.jit
        def fwd_vjp(p, ct):
            L, pull = jax.vjp(f, p)
            return L, pull(ct)[0]

        La, ga = fwd_vjp(jp, jnp.asarray(cot))
        La = np.asarray(La)
        bad = bad_lanes(La)
        ct = cot * ~bad[:, None]
        if bad.any():
            ga = fwd_vjp(jp, jnp.asarray(ct))[1]
    else:
        with jax.disable_jit():
            La, vjp = jax.vjp(f, jp)
            La = np.asarray(La)
            bad = bad_lanes(La)
            ct = cot * ~bad[:, None]
            ga = vjp(jnp.asarray(ct))[0]
    ga = jax.tree.map(np.asarray, ga)
    gs = torch.autograd.grad(Lb, [v for _, _, v in leaves], tt(ct),
                             allow_unused=True)
    gb = {}
    for (grp, k, v), gv in zip(leaves, gs):
        gb.setdefault(grp, {})[k] = (np.zeros(v.shape, np.float32)
                                     if gv is None else np_(gv))
    return ga, gb, La, np_(Lb)


def assert_grad_close(ga, gb, floor=0.0, rows=None):
    """One leaf's gradient of the port (gb) against the JAX package's (ga)
    at BASELINE's tolerance: rtol 1e-3 and atol 1e-3 max|ga|, the maximum
    taken no lower than `floor` (the float32 noise level of the case);
    `rows` restricts the comparison to those leading rows. The port's is
    finite everywhere."""
    assert np.isfinite(gb).all()
    if rows is not None:
        ga, gb = ga[rows], gb[rows]
    atol = 1e-3 * max(np.abs(ga).max(), floor)
    np.testing.assert_allclose(gb, ga, rtol=1e-3, atol=atol)


def assert_radiance_close(La, aa, Lb, ab, share=0.01, albedo_atol=1e-5,
                          count_rays=True):
    """The per-lane thresholds of tests/test_torch_render_materials.py: a
    lane whose path meets a rounding-level decision may take another path,
    so at most `share` of lanes diverge; the means agree within 0.5%; the
    first-bounce AOVs agree on the other lanes (the albedo within
    `albedo_atol`); the ray counts within 1% (`count_rays`: not against
    the JAX package's CPU BVH walk, which counts every gated shadow
    lane)."""
    R = La.shape[0]
    bad = (np.abs(La - Lb) > 1e-4 + 1e-3 * np.abs(La)).any(-1)
    assert bad.mean() <= share, bad.sum()
    assert La.mean() > 0.01
    assert abs(Lb.mean() / La.mean() - 1.0) < 0.005
    np.testing.assert_allclose(np_(ab["albedo"])[~bad],
                               np.asarray(aa["albedo"])[~bad], atol=albedo_atol)
    np.testing.assert_allclose(np_(ab["normal"])[~bad],
                               np.asarray(aa["normal"])[~bad], atol=1e-4)
    if count_rays:
        assert abs(int(ab["nrays"]) - float(aa["nrays"])) <= 0.01 * R
    return int(bad.sum())


def jax_wave(js, spp=4):
    """The JAX package's regeneration wavefront (frame 0) as numpy."""
    import jax.numpy as jnp
    from vision_tpu.render import _wave_pass
    img, aov = _wave_pass(js.data, js.camera, js.filter, jnp.uint32(0), spp,
                          js.max_depth, js.min_depth,
                          jnp.float32(js.rr_threshold))
    return np.asarray(img), {k: np.asarray(v) for k, v in aov.items()}


def assert_wave_close(ps, ref, spp=4, count_rays=True):
    """The port's regeneration wavefront from the same seeds against the
    JAX one: 8x8 block error and bias <= 0.01, equal sample counts, loop
    counts within 2, ray counts within 1% (dense scenes)."""
    from vision_tpu_torch.integrator import pt as tpt
    ia, aa = ref
    ib, ab = tpt.render_wave(ps.data, ps.camera, ps.filter, 0, spp,
                             ps.max_depth, ps.min_depth, ps.rr_threshold)
    werr, bias = block_err(np_(ib), ia)
    assert werr <= 0.01 and abs(bias) <= 0.01, (werr, bias)
    assert np.array_equal(np_(ab["smp"]), aa["smp"])
    assert abs(ab["iters"] - int(aa["iters"])) <= 2
    if count_rays:
        assert abs(int(ab["nrays"]) / float(aa["nrays"]) - 1.0) < 0.01
    return werr
