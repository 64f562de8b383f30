"""The real-time loop's modules in the port against the JAX package, module
by module, on the JAX package's own inputs: its G-buffers, reservoirs and
cache samples after two frames of its loop on the cornell box (32^2),
carried across as numpy. Both sides then draw the same RNG stream, so the
lanes are held tightly; a lane whose reservoir choice sits on a rounding
knife edge (u * wsum < w, an int cast of a tap offset, a LOD level) may
take another sample, and at most PARTED of the lanes may part."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vision_tpu_torch as vt
from tests.torch_parity import (assert_radiance_close, cbox, np_,
                                port_record, radiance_both, tt)
from vision_tpu.caches import sharc as jsh
from vision_tpu.caches import surfel as jsf
from vision_tpu.core import rng as jrng
from vision_tpu.integrator import realtime as jrt
from vision_tpu.integrator import restir as jdi
from vision_tpu.integrator import restir_gi as jgi
from vision_tpu.post import denoise as jdn
from vision_tpu.post import svgf as jsv
from vision_tpu.post import upsample as jup
from vision_tpu.scene.scene import Scene as JScene
from vision_tpu.sensor import gbuffer as jgb
from vision_tpu_torch.caches import sharc as tsh
from vision_tpu_torch.caches import surfel as tsf
from vision_tpu_torch.core import rng as trng
from vision_tpu_torch.integrator import restir as tdi
from vision_tpu_torch.integrator import restir_gi as tgi
from vision_tpu_torch.post import denoise as tdn
from vision_tpu_torch.post import svgf as tsv
from vision_tpu_torch.post import upsample as tup
from vision_tpu_torch.sensor import gbuffer as tgb

torch.set_num_threads(2)

RES = 32
N = RES * RES
PARTED = 0.02        # share of lanes allowed to take another sample
RTOL, ATOL = 1e-4, 1e-5   # the other lanes
FIELD_RTOL = 1e-5         # deterministic per-lane fields (G-buffer, caches)


def lanes_close(b, a, rtol=RTOL, atol=ATOL, share=PARTED):
    """b (port) within (rtol, atol) of a (JAX) on all but `share` of the
    lanes (leading axis). Returns the parted-lane mask."""
    a = np.asarray(a).astype(np.float64)
    b = np_(b).astype(np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    off = ~np.isclose(b, a, rtol=rtol, atol=atol)
    off = off.reshape(off.shape[0], -1).any(-1)
    assert off.mean() <= share, (off.sum(), off.shape[0])
    return off


def moved(c2w, dx):
    m = np.array(c2w)
    m[0, 3] += dx
    return m


@pytest.fixture(scope="module")
def loop():
    """Both scenes, and the JAX package's state after two frames of its
    loop at the defaults."""
    js = JScene(cbox(RES))
    ps = vt.load_scene(cbox(RES), device="cpu")
    st = jrt.RealTimeState.initial((RES, RES))
    for _ in range(2):
        _, st = jrt.render_realtime(js.data, js.camera, st)
    return js, ps, st


def gbuffers(js, frame):
    """The JAX G-buffer of `frame` (static camera) and the port's copy."""
    gb = jgb.compute_gbuffer(js.data, js.camera, frame)
    return gb, port_record(gb, tgb.GBuffer)


def seeds(salt, frame):
    j = jrng.seed(jnp.arange(N, dtype=jnp.uint32) ^ jnp.uint32(salt),
                  jnp.uint32(frame))
    t = trng.seed(torch.arange(N) ^ salt, frame)
    np.testing.assert_array_equal(np_(t), np.asarray(j).astype(np.int64))
    return j, t


def test_radiance_without_primary():
    """include_primary=False (ReSTIR GI's paths) per lane: the light the
    first segment sees directly weighs 0 in both packages."""
    js, ps = JScene(cbox(RES)), vt.load_scene(cbox(RES), device="cpu")
    La, aa, Lb, ab = radiance_both(js, ps, RES, max_depth=3,
                                   include_primary=False)
    assert_radiance_close(La, aa, Lb, ab)
    Lp = radiance_both(js, ps, RES, max_depth=3)[0]
    assert (La <= Lp + 1e-6).all() and La.mean() < Lp.mean()


def test_gbuffer_per_lane(loop):
    """Every G-buffer field per lane, with a moved previous camera for the
    motion vectors, jittered and not."""
    js, ps, _ = loop
    m = moved(np.asarray(js.camera.c2w), 0.2)
    jprev = js.camera.replace(c2w=jnp.asarray(m))
    tprev = dataclasses.replace(ps.camera, c2w=tt(m))
    for jitter in (True, False):
        a = jgb.compute_gbuffer(js.data, js.camera, 3, prev_camera=jprev,
                                jitter=jitter)
        b = tgb.compute_gbuffer(ps.data, ps.camera, 3, prev_camera=tprev,
                                jitter=jitter)
        for f in dataclasses.fields(tgb.GBuffer):
            x, y = np.asarray(getattr(a, f.name)), np_(getattr(b, f.name))
            if x.dtype in (np.bool_, np.int32):
                np.testing.assert_array_equal(y, x, err_msg=f.name)
            else:
                np.testing.assert_allclose(y, x, rtol=FIELD_RTOL, atol=1e-4,
                                           err_msg=f.name)
        assert np.abs(np.asarray(a.motion)).max() > 0.5


def test_gbuffer_emission_rows():
    """48^2 without jitter: the area light lights the top rows only, as in
    the JAX package's test, and per lane as the JAX G-buffer."""
    js, ps = JScene(cbox(48)), vt.load_scene(cbox(48), device="cpu")
    a = jgb.compute_gbuffer(js.data, js.camera, 0, jitter=False)
    b = tgb.compute_gbuffer(ps.data, ps.camera, 0, jitter=False)
    em = np_(b.emission).reshape(48, 48, 3)
    assert em[:10].max() > 10.0 and em[20:].max() == 0.0
    np.testing.assert_allclose(np_(b.emission), np.asarray(a.emission),
                               rtol=FIELD_RTOL)


@pytest.mark.parametrize("with_prev", [False, True])
def test_restir_di_per_lane(loop, with_prev):
    """ReSTIR DI on the JAX G-buffer of frame 2, with and without the JAX
    loop's reservoir and G-buffer of frame 1 as the temporal input: the
    direct light, the persistent reservoir and the RNG state."""
    js, ps, st = loop
    jg, tg = gbuffers(js, 2)
    jst, tst = seeds(0x9E3779B9, 2)
    jprev = tprev = None
    if with_prev:
        jprev = (st.reservoir, st.gbuffer)
        tprev = (port_record(st.reservoir, tdi.Reservoir),
                 port_record(st.gbuffer, tgb.GBuffer))
    ja, La, ra = jdi.restir_di(js.data, jg, jst, prev=jprev, m_light=8,
                               spatial_taps=2, resolution=(RES, RES))
    tb, Lb, rb = tdi.restir_di(ps.data, tg, tst, prev=tprev, m_light=8,
                               spatial_taps=2, resolution=(RES, RES))
    np.testing.assert_array_equal(np_(tb), np.asarray(ja).astype(np.int64))
    lanes_close(Lb, La)
    for f in dataclasses.fields(tdi.Reservoir):
        lanes_close(getattr(rb, f.name), getattr(ra, f.name))
    assert float(np.asarray(La).mean()) > 0.01


@pytest.mark.parametrize("case", ["first", "sharc", "surfel"])
def test_restir_gi_per_lane(loop, case):
    """ReSTIR GI on the JAX G-buffer of frame 2: the first frame without
    a cache; then with the JAX loop's GI reservoir and G-buffer of frame 1,
    querying the JAX loop's SHARC cache, or a surfel pool the JAX package
    spawned and filled from the same samples. The indirect light, the
    reservoir and the cache-update samples."""
    js, ps, st = loop
    jg, tg = gbuffers(js, 2)
    jst, tst = seeds(0x7F4A7C15, 2)
    cam = js.camera.c2w[:3, 3]
    kw_j, kw_t = {}, {}
    if case != "first":
        kw_j["prev"] = (st.gi_reservoir, st.gbuffer)
        kw_t["prev"] = (port_record(st.gi_reservoir, tgi.GIReservoir),
                        port_record(st.gbuffer, tgb.GBuffer))
    if case == "sharc":
        c = st.sharc
        kw_j["sharc"] = c
        kw_t["sharc"] = port_record(c, tsh.SharcCache,
                                    base_voxel=c.base_voxel,
                                    capacity=c.capacity)
    if case == "surfel":
        _, _, _, (x, n, L, ok) = jgi.restir_gi(
            js.data, gbuffers(js, 1)[0], jst, resolution=(RES, RES))
        pool = jsf.SurfelPool.create(1 << 12, cell_size=0.15)
        for _ in range(2):
            pool = jsf.accumulate(jsf.spawn(pool, x, n, ok), x, L, ok)
        kw_j["surfel"] = pool
        kw_t["surfel"] = port_record(pool, tsf.SurfelPool,
                                     cell_size=pool.cell_size,
                                     capacity=pool.capacity)
    ja, La, ra, ca = jgi.restir_gi(js.data, jg, jst, resolution=(RES, RES),
                                   cam_pos=cam, **kw_j)
    tb, Lb, rb, cb = tgi.restir_gi(ps.data, tg, tst, resolution=(RES, RES),
                                   cam_pos=tt(cam), **kw_t)
    np.testing.assert_array_equal(np_(tb), np.asarray(ja).astype(np.int64))
    lanes_close(Lb, La)
    for f in dataclasses.fields(tgi.GIReservoir):
        lanes_close(getattr(rb, f.name), getattr(ra, f.name))
    for x, y in zip(ca, cb):
        lanes_close(y, x)
    assert float(np.asarray(La).mean()) > 0.005


def test_sharc(loop):
    """SHARC's update, resolve, query and compaction on the JAX loop's
    cache samples plus seeded points on both sides of the origin (negative
    cells wrap as the JAX package's uint32 cast does): slots and keys bit
    for bit, the float sums at FIELD_RTOL."""
    js, _, st = loop
    jg, _ = gbuffers(js, 2)
    jst, _ = seeds(0x7F4A7C15, 2)
    _, _, _, (x, n, L, ok) = jgi.restir_gi(js.data, jg, jst,
                                           resolution=(RES, RES))
    g = np.random.default_rng(3)
    xr = g.uniform(-3, 3, (512, 3)).astype(np.float32)
    nr = g.normal(size=(512, 3)).astype(np.float32)
    x = jnp.concatenate([x, jnp.asarray(xr)])
    n = jnp.concatenate([n, jnp.asarray(nr)])
    L = jnp.concatenate([L, jnp.asarray(g.random((512, 3), np.float32))])
    ok = jnp.concatenate([ok, jnp.asarray(g.random(512) < 0.8)])
    cam = js.camera.c2w[:3, 3]
    jc = jsh.SharcCache.create(1 << 10, 0.05)
    tc = tsh.SharcCache.create(1 << 10, 0.05, device="cpu")
    slot_a, key_a = jsh._cell_of(jc, x, n, cam)
    slot_b, key_b = tsh._cell_of(tc, tt(x), tt(n), tt(cam))
    np.testing.assert_array_equal(np_(slot_b), np.asarray(slot_a))
    np.testing.assert_array_equal(np_(key_b), np.asarray(key_a).astype(np.int64))
    for _ in range(4):
        jc = jsh.resolve(jsh.update(jc, x, n, L, cam, ok))
        tc = tsh.resolve(tsh.update(tc, tt(x), tt(n), tt(L), tt(cam), tt(ok)))
        np.testing.assert_array_equal(np_(tc.key),
                                      np.asarray(jc.key).astype(np.int64))
        for k in ("radiance", "total_n"):
            np.testing.assert_allclose(np_(getattr(tc, k)),
                                       np.asarray(getattr(jc, k)),
                                       rtol=FIELD_RTOL, atol=1e-6)
    qa, oka = jsh.query(jc, x, n, cam)
    qb, okb = tsh.query(tc, tt(x), tt(n), tt(cam))
    np.testing.assert_array_equal(np_(okb), np.asarray(oka))
    assert np.asarray(oka).mean() > 0.5
    np.testing.assert_allclose(np_(qb), np.asarray(qa), rtol=FIELD_RTOL,
                               atol=1e-6)
    jc = jsh.compaction(jc, min_count=4.0, decay=0.5)
    tc = tsh.compaction(tc, min_count=4.0, decay=0.5)
    np.testing.assert_array_equal(np_(tc.key), np.asarray(jc.key).astype(np.int64))
    np.testing.assert_allclose(np_(tc.total_n), np.asarray(jc.total_n),
                               rtol=FIELD_RTOL)


def _cells(k, cell=0.5, offset=(0.3, 0.4, 0.5)):
    """k points, one in each of k distinct cells of size `cell`."""
    i = np.arange(k)
    return ((np.stack([i % 7 - 3, i // 7 % 7 - 3, i // 49 - 1], -1)
             + np.asarray(offset)) * cell).astype(np.float32)


@pytest.mark.parametrize("per_cell", [1, 3])
def test_surfel_without_the_quirk(per_cell):
    """The surfel pool's spawn, accumulate and query equal the JAX
    package's where no cell's last lane is masked off (C14 does not show):
    k distinct cells in distinct slots, each written by `per_cell` lanes
    whose last one is live."""
    k = 60
    p = np.repeat(_cells(k), per_cell, 0)
    p = p + np.random.default_rng(4).uniform(-0.05, 0.05, p.shape).astype(
        np.float32)
    n = np.tile(np.asarray([[0.0, 0.0, 1.0]], np.float32), (len(p), 1))
    g = np.random.default_rng(5)
    mask = g.random(len(p)) < 0.7
    if per_cell > 1:
        mask[per_cell - 1::per_cell] = True  # each cell's last lane is live
    rad = g.random((len(p), 3)).astype(np.float32)
    ja = jsf.SurfelPool.create(1 << 16, cell_size=0.5)
    tb = tsf.SurfelPool.create(1 << 16, cell_size=0.5, device="cpu")
    slots = np.asarray(jsf._slot(ja, jnp.asarray(_cells(k))))
    assert len(set(slots.tolist())) == k
    np.testing.assert_array_equal(np_(tsf._slot(tb, tt(p))),
                                  np.asarray(jsf._slot(ja, jnp.asarray(p))))
    for _ in range(5):
        ja = jsf.accumulate(jsf.spawn(ja, jnp.asarray(p), jnp.asarray(n),
                                      jnp.asarray(mask)),
                            jnp.asarray(p), jnp.asarray(rad), jnp.asarray(mask))
        tb = tsf.accumulate(tsf.spawn(tb, tt(p), tt(n), tt(mask)), tt(p),
                            tt(rad), tt(mask))
    for f in ("pos", "normal", "radius", "live", "count"):
        np.testing.assert_array_equal(np_(getattr(tb, f)),
                                      np.asarray(getattr(ja, f)), err_msg=f)
    np.testing.assert_allclose(np_(tb.irradiance), np.asarray(ja.irradiance),
                               rtol=FIELD_RTOL)
    va, wa = jsf.query(ja, jnp.asarray(p), jnp.asarray(n))
    vb, wb = tsf.query(tb, tt(p), tt(n))
    assert (np.asarray(wa) > 0).mean() > 0.5
    np.testing.assert_allclose(np_(wb), np.asarray(wa), rtol=FIELD_RTOL)
    np.testing.assert_allclose(np_(vb), np.asarray(va), rtol=FIELD_RTOL,
                               atol=1e-7)


@pytest.mark.parametrize("mask", [[True, False], [False, True]])
def test_surfel_spawn_two_lanes_one_cell(mask):
    """C14: two points in one empty cell. The JAX package lets its last
    lane write the slot even when that lane is masked off, which undoes
    the first lane's spawn ([True, False] leaves the slot dead and its
    position 0). The port spawns from the highest fresh lane, so both
    masks spawn a surfel; with [False, True] the packages agree."""
    p = np.asarray([[0.1, 0.1, 0.1], [0.2, 0.15, 0.1]], np.float32)
    n = np.asarray([[0.0, 1.0, 0.0]] * 2, np.float32)
    m = np.asarray(mask)
    ja = jsf.spawn(jsf.SurfelPool.create(1 << 8, 0.5), jnp.asarray(p),
                   jnp.asarray(n), jnp.asarray(m))
    tb = tsf.spawn(tsf.SurfelPool.create(1 << 8, 0.5, device="cpu"), tt(p),
                   tt(n), tt(m))
    s = int(np.asarray(jsf._slot(ja, jnp.asarray(p[:1])))[0])
    assert int(tsf._slot(tb, tt(p[:1]))[0]) == s
    lane = int(np.flatnonzero(m)[0])
    assert bool(tb.live[s]) and int(tb.live.sum()) == 1
    np.testing.assert_array_equal(np_(tb.pos[s]), p[lane])
    assert float(tb.radius[s]) == 0.5
    if mask == [True, False]:    # the documented deviation
        assert not bool(np.asarray(ja.live).any())
        assert not np.asarray(ja.pos).any()
    else:
        for f in ("pos", "normal", "radius", "live"):
            np.testing.assert_array_equal(np_(getattr(tb, f)),
                                          np.asarray(getattr(ja, f)))


def _images(h=RES, w=RES, seed=6):
    g = np.random.default_rng(seed)
    color = g.random((h, w, 3), np.float32) * 2.0
    n = g.normal(size=(h, w, 3)) + np.asarray([0.0, 0.0, 3.0])
    normal = (n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(np.float32)
    albedo = g.uniform(0.1, 0.9, (h, w, 3)).astype(np.float32)
    depth = g.uniform(3.0, 6.0, (h, w)).astype(np.float32)
    motion = g.uniform(-1.5, 1.5, (h, w, 2)).astype(np.float32)
    return color, normal, albedo, depth, motion


@pytest.mark.parametrize("prev_guides", [False, True])
def test_svgf(prev_guides):
    """Two SVGF frames on the same seeded arrays (the second reprojects
    the first's history through non-integer motion), with and without the
    previous normal and depth, every history length through the spatial
    and the temporal variance."""
    color, normal, albedo, depth, motion = _images()
    h, w = depth.shape
    ja, tb = jsv.init_state(h, w), tsv.init_state(h, w, device="cpu")
    ja = ja.replace(history=jnp.asarray(np.arange(h * w).reshape(h, w) % 6,
                                        jnp.float32))
    tb = dataclasses.replace(tb, history=tt(np.asarray(ja.history)))
    kw_j = kw_t = {}
    if prev_guides:
        kw_j = dict(prev_normal=jnp.asarray(normal[::-1]),
                    prev_depth=jnp.asarray(depth * 1.05))
        kw_t = dict(prev_normal=tt(normal[::-1]), prev_depth=tt(depth * 1.05))
    for f in range(2):
        c = color * (1.0 + 0.3 * f)
        oa, ja = jsv.svgf_filter(*(jnp.asarray(x) for x in
                                   (c, albedo, normal, depth, motion)), ja,
                                 n_passes=3, **kw_j)
        ob, tb = tsv.svgf_filter(*(tt(x) for x in
                                   (c, albedo, normal, depth, motion)), tb,
                                 n_passes=3, **kw_t)
        np.testing.assert_allclose(np_(ob), np.asarray(oa), rtol=1e-4,
                                   atol=1e-5)
        for k in ("illum", "moments", "history"):
            np.testing.assert_allclose(np_(getattr(tb, k)),
                                       np.asarray(getattr(ja, k)),
                                       rtol=1e-5, atol=1e-6)


def test_bilateral_upsample():
    """The GI upsampling on seeded arrays (the JAX function is jitted: XLA
    fuses its weights, so a few elements round differently)."""
    _, normal, _, depth, _ = _images(32, 40)
    low = np.random.default_rng(7).random((13, 17, 3), np.float32)
    a = jup.bilateral_upsample(jnp.asarray(low), jnp.asarray(normal),
                               jnp.asarray(depth))
    b = tup.bilateral_upsample(tt(low), tt(normal), tt(depth))
    assert b.shape == (32, 40, 3)
    np.testing.assert_allclose(np_(b), np.asarray(a), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("which", ["atrous_pass", "denoise_aov",
                                   "denoise_simple"])
def test_denoisers(which):
    color, normal, albedo, _, _ = _images()
    if which == "atrous_pass":
        a = jdn.atrous_pass(*(jnp.asarray(x) for x in (color, normal, albedo)),
                            2)
        b = tdn.atrous_pass(*(tt(x) for x in (color, normal, albedo)), 2)
    elif which == "denoise_aov":
        a = jdn.denoise_aov(*(jnp.asarray(x) for x in (color, normal, albedo)))
        b = tdn.denoise_aov(*(tt(x) for x in (color, normal, albedo)))
    else:
        a = jdn.denoise_simple(jnp.asarray(color))
        b = tdn.denoise_simple(tt(color))
    np.testing.assert_allclose(np_(b), np.asarray(a), rtol=1e-4, atol=1e-5)
