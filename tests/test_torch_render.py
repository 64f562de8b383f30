"""The port's integrator and renderer against the JAX package on the cornell
box: per-lane `radiance` on the same rays and RNG states, and the
regeneration wavefront on the same pixels and seeds."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vision_tpu_torch as vt
from tests.torch_parity import block_err, cbox, np_, tt
from vision_tpu.core import rng as jrng
from vision_tpu.integrator import pt as jpt
from vision_tpu.scene.scene import Scene as JScene
from vision_tpu_torch.core import rng as trng
from vision_tpu_torch.core.types import Hit
from vision_tpu_torch.integrator import pt as tpt

torch.set_num_threads(2)


def test_compute_interaction_and_spawn():
    """Surface interaction and ray spawning from the same cbox hits."""
    js = JScene(cbox(32))
    ps = vt.load_scene(cbox(32), device="cpu")
    g = np.random.default_rng(1)
    p_film = (g.random((1024, 2)) * 32).astype(np.float32)
    jray = js.camera.generate_ray(jnp.asarray(p_film))
    hit = jpt.trace_closest(js.data, jray)
    thit = Hit(t=tt(hit.t), prim_id=tt(hit.prim_id), bary=tt(hit.bary))
    a = jpt.compute_interaction(js.data, jray, hit)
    b = tpt.compute_interaction(ps.data, thit)
    for x, y in zip(a, b):
        np.testing.assert_allclose(np_(y), np.asarray(x), rtol=1e-5, atol=1e-6)
    w = g.normal(size=(1024, 3)).astype(np.float32)
    np.testing.assert_allclose(
        np_(tpt.spawn_origin(b[0], b[1], tt(w), 1.0)),
        np.asarray(jpt.spawn_origin(a[0], a[1], jnp.asarray(w), 1.0)),
        rtol=1e-5, atol=1e-6)


def test_radiance_per_lane():
    """Per-lane radiance at depth 2 (bounce-major `radiance`) on the same
    camera rays and RNG states. Float rounding differs between XLA and
    eager torch, so a lane whose path meets a rounding-level decision
    (Russian roulette at u ~ q, an exact-t tie) may take another path: at
    most 1% of lanes may diverge, and the means agree within 0.5%."""
    res = 48
    js = JScene(cbox(res))
    ps = vt.load_scene(cbox(res), device="cpu")
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
    tst = trng.seed(torch.arange(R), tt(seeds.astype(np.int64)))
    Lb, ab = tpt.radiance(ps.data, tray, tst, max_depth=2)
    Lb = np_(Lb)
    bad = (np.abs(La - Lb) > 1e-4 + 1e-3 * np.abs(La)).any(-1)
    assert bad.mean() <= 0.01, bad.sum()
    assert La.mean() > 0.01
    assert abs(Lb.mean() / La.mean() - 1.0) < 0.005
    np.testing.assert_allclose(np_(ab["albedo"])[~bad],
                               np.asarray(aa["albedo"])[~bad], atol=1e-5)
    np.testing.assert_allclose(np_(ab["normal"])[~bad],
                               np.asarray(aa["normal"])[~bad], atol=1e-4)
    assert abs(int(ab["nrays"]) - float(aa["nrays"])) <= 0.01 * R


def test_render_wave_matches_jax():
    """The regeneration wavefront, 32^2 at 4 spp, both packages from the
    same seeds: 8x8 block error <= 0.01, equal loop and ray counts up to
    a few divergent lanes."""
    from vision_tpu.render import _wave_pass
    res, spp = 32, 4
    js = JScene(cbox(res))
    ps = vt.load_scene(cbox(res), device="cpu")
    ia, aa = _wave_pass(js.data, js.camera, js.filter, jnp.uint32(0), spp,
                        js.max_depth, js.min_depth,
                        jnp.float32(js.rr_threshold))
    ib, ab = tpt.render_wave(ps.data, ps.camera, ps.filter, 0, spp,
                             ps.max_depth, ps.min_depth, ps.rr_threshold)
    werr, bias = block_err(np_(ib), np.asarray(ia))
    assert werr <= 0.01 and abs(bias) <= 0.01, (werr, bias)
    assert np.array_equal(np_(ab["smp"]), np.asarray(aa["smp"]))
    assert abs(ab["iters"] - int(aa["iters"])) <= 2
    assert abs(int(ab["nrays"]) / float(aa["nrays"]) - 1.0) < 0.01


def test_render_sample_matches_jax():
    """One sample per pixel through `render_sample` (16^2, depth 8)."""
    res = 16
    js = JScene(cbox(res))
    ps = vt.load_scene(cbox(res), device="cpu")
    ia, _ = jax.jit(lambda d, c, f: jpt.render_sample(d, c, f, 5,
                                                      max_depth=8))(
        js.data, js.camera, js.filter)
    ib, ab = tpt.render_sample(ps.data, ps.camera, ps.filter, 5, max_depth=8)
    ia = np.asarray(ia)
    bad = (np.abs(ia - np_(ib)) > 1e-4 + 1e-3 * np.abs(ia)).any(-1)
    assert bad.mean() <= 0.02, bad.sum()
    assert ab["albedo"].shape == (res, res, 3)


def _read_png(path):
    """A small PNG reader for what `film.to_png` writes (8-bit RGB, no
    interlace, filter 0 on every row): checks the signature, each chunk's
    CRC, and returns the pixels [H, W, 3] uint8."""
    import struct
    import zlib
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, []
    while pos < len(data):
        n, = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        crc, = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(kind + body) & 0xFFFFFFFF, kind
        chunks.append((kind, body))
        pos += 12 + n
    assert [k for k, _ in chunks] == [b"IHDR", b"IDAT", b"IEND"]
    w, h, depth, ctype, comp, filt, lace = struct.unpack(">IIBBBBB",
                                                         chunks[0][1])
    assert (depth, ctype, comp, filt, lace) == (8, 2, 0, 0, 0)
    raw = np.frombuffer(zlib.decompress(chunks[1][1]), np.uint8)
    raw = raw.reshape(h, 1 + 3 * w)
    assert (raw[:, 0] == 0).all()
    return raw[:, 1:].reshape(h, w, 3)


def test_render_to_file(tmp_path):
    """render_to_file with the JAX package's argument order
    (scene, out_path, spp, verbose) and the device by keyword writes the
    tonemapped render as a PNG, and for an `.exr` path the linear render as
    OpenEXR, which reads back bit for bit."""
    path = tmp_path / "cbox.png"
    s = cbox(8)
    s["output"]["spp"] = 1
    assert vt.render_to_file(s, str(path), None, False, device="cpu") \
        == str(path)
    assert path.stat().st_size > 0
    sc = vt.load_scene(s, device="cpu")
    want = vt.postprocess(sc, vt.render(sc, spp=1)).numpy()
    want = np.clip(want * 255.0 + 0.5, 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(_read_png(path), want)
    from vision_tpu_torch.scene.imageio import read_image
    exr = str(tmp_path / "cbox.exr")
    assert vt.render_to_file(s, exr, None, False, device="cpu") == exr
    got, kind = read_image(exr)
    assert kind == "hdr"
    np.testing.assert_array_equal(got, vt.render(sc, spp=1).numpy())


@pytest.mark.parametrize("shape", [(1, 1), (5, 3), (16, 17)])
def test_to_png_without_pil(tmp_path, shape, monkeypatch):
    """film.to_png writes an 8-bit RGB PNG with the standard library alone
    (PIL is made unimportable): its pixels are clip(img * 255 + 0.5), read
    back by the small reader above and, where PIL exists here, by PIL."""
    import builtins
    from vision_tpu_torch.sensor import film
    g = np.random.default_rng(sum(shape))
    img = g.random(shape + (3,), dtype=np.float32) * 1.2 - 0.1
    path = tmp_path / "x.png"
    real_import = builtins.__import__

    def no_pil(name, *a, **k):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("PIL is not available")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    film.to_png(img, str(path))
    monkeypatch.undo()
    want = np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(_read_png(path), want)
    try:
        from PIL import Image
    except ImportError:
        return
    np.testing.assert_array_equal(np.asarray(Image.open(path).convert("RGB")),
                                  want)


def test_dense_gating_changes_nothing(monkeypatch):
    """The dense path traces lanes outside `act` with t_max = 0 (the K1
    kernels skip them); `radiance` and `render_wave` come out bit for bit
    as when every lane is swept, as the JAX package's dense path does."""
    ps = vt.load_scene(cbox(16), device="cpu")
    assert ps.data.pbvh is None and ps.data.ipbvh is None
    R = 16 * 16
    g = np.random.default_rng(2)
    p_film = (np.stack([np.arange(R) % 16, np.arange(R) // 16], -1)
              + g.random((R, 2))).astype(np.float32)
    ray = ps.camera.generate_ray(tt(p_film))
    st = trng.seed(torch.arange(R), tt(g.integers(0, 2 ** 32, R)))

    def run():
        L, aov = tpt.radiance(ps.data, ray, st, max_depth=4)
        img, wav = tpt.render_wave(ps.data, ps.camera, ps.filter, 0, 2,
                                   ps.max_depth, ps.min_depth,
                                   ps.rr_threshold)
        return [L, img] + [aov[k] for k in ("albedo", "normal", "nrays")] \
            + [wav[k] for k in ("albedo", "normal", "nrays", "film", "smp")]

    gated = run()
    monkeypatch.setattr(tpt, "_gated", lambda r, act: (
        r.origin.contiguous(), r.direction.contiguous(), r.t_max.contiguous()))
    swept = run()
    for a, b in zip(gated, swept):
        assert torch.equal(a, b)
