"""Make the golden of the real-time loop with the JAX package on the CPU:
the reference `chip_smoke.py` holds the port's real-time frames against.

    JAX_PLATFORMS=cpu python tools/gen_torch_rt_golden.py [out.npz]

Runs `vision_tpu.integrator.realtime.render_realtime` on the cornell box
(tests/fixtures.py CBOX_JSON) at 128x128 with its defaults (m_light 8,
spatial_taps 2, svgf_passes 3, SHARC, gi_bounce_depth 2, GI at full
resolution) and a static camera, from `RealTimeState.initial` for FRAMES
frames, and writes `tests/goldens/cbox_rt_hdr.npz` (or `out.npz`): the
display images of frames 0 and FRAMES - 1 (`frame0`, `frame7`, float32
[128, 128, 3]), the settings, each frame's mean and the seconds taken. The
loop's RNG streams are keyed by pixel and frame only, so the port run from
the same state follows the same samples up to float rounding.

Measured on an 8-core CPU host, JAX on the CPU, op by op: see the
`seconds` entry of the file (68 s for the eight frames: 40 s for the
first, which compiles, then about 4 s a frame).
"""
import copy
import os
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

RES = 128
FRAMES = 8
SETTINGS = dict(m_light=8, spatial_taps=2, svgf_passes=3, gi=True,
                use_sharc=True, gi_bounce_depth=2, gi_scale=1.0)


def main():
    from tests.fixtures import CBOX_JSON
    from vision_tpu.integrator.realtime import RealTimeState, render_realtime
    from vision_tpu.scene.scene import Scene

    out_path = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        ROOT, "tests", "goldens", "cbox_rt_hdr.npz")
    desc = copy.deepcopy(CBOX_JSON)
    desc["camera"]["param"]["radiance_collector"]["param"]["resolution"] = [
        RES, RES]
    sc = Scene(desc)
    state = RealTimeState.initial((RES, RES))
    frames, means = {}, []
    t0 = time.time()
    for f in range(FRAMES):
        img, state = render_realtime(sc.data, sc.camera, state, **SETTINGS)
        img = np.asarray(img, np.float32)
        means.append(float(img.mean()))
        if f in (0, FRAMES - 1):
            frames[f"frame{f}"] = img
        print(f"frame {f}: mean {means[-1]:.5f}, {time.time() - t0:.1f} s",
              flush=True)
    seconds = time.time() - t0
    assert int(state.frame) == FRAMES
    assert all(np.isfinite(v).all() for v in frames.values())
    np.savez_compressed(out_path, res=RES, frames=FRAMES, means=means,
                        seconds=seconds, **frames,
                        **{k: np.asarray(v) for k, v in SETTINGS.items()})
    print(f"wrote {out_path}", flush=True)


if __name__ == "__main__":
    main()
