"""ROADMAP C25: single-byte edits of OpenEXR files, held against OpenCV
4.6.0 over libOpenEXR 3.1 (the reference of the port's OpenEXR decoder,
ROADMAP C22). `tools/gen_torch_exr.py` draws the edits from a seed (a
byte set to 0, 1 or 255 or one of its bits flipped, in each file's
header, chunk offset table and chunks; one small file a codec, scanlines
and tiles), reads each edited file through `tools/cv_read.cpp` twice
under two values of glibc's MALLOC_PERTURB_, and commits each outcome to
`tests/assets_torch/exr_edits.json`: the sha256 of the decode as the JAX
package's loader returns it, "empty" (OpenCV returns no image), "crash"
(cv_read dies) or "undefined" (the two reads differ: memory the decoder
never wrote). The port gives each decode bit for bit and refuses
(ValueError) the rest. Tolerance: exact."""
import hashlib
import importlib.util
import json
import os

import pytest

from tests.torch_scenes import ASSETS
from vision_tpu_torch.scene import imageio as tio

_spec = importlib.util.spec_from_file_location(
    "vt_gen_torch_exr", os.path.join(os.path.dirname(ASSETS), "..", "tools",
                                     "gen_torch_exr.py"))
gen_exr = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(gen_exr)

with open(os.path.join(ASSETS, "exr_edits.json")) as _f:
    EDITS = json.load(_f)
FILES = {}
for _fn in gen_exr.EDIT_FILES:
    with open(os.path.join(ASSETS, _fn), "rb") as _f:
        FILES[_fn] = _f.read()


def test_edits_replay_from_their_seed():
    """The committed edits are the ones the seed draws, in each region of
    each file, with the counts the generator asks for; no outcome was
    read from uninitialised memory (none differs between the two reads)."""
    assert EDITS["seed"] == gen_exr.EDIT_SEED
    drawn = gen_exr.edits(FILES)
    assert [list(e) for e in drawn] == [r[:3] for r in EDITS["edits"]]
    assert len(drawn) == len(gen_exr.EDIT_FILES) * sum(gen_exr.EDIT_COUNTS)
    kinds = [r[3] for r in EDITS["edits"]]
    assert "undefined" not in kinds
    assert {"empty", "crash"} <= set(kinds)
    assert sum(len(k) == 64 for k in kinds) > len(kinds) // 2


@pytest.mark.parametrize("fn", gen_exr.EDIT_FILES)
def test_edited_files_match_opencv(tmp_path, fn):
    """Each edit of `fn`: the port's decode has the sha256 of OpenCV's, or
    the port refuses the file where OpenCV returns no image, dies or reads
    memory it never wrote."""
    p = str(tmp_path / "edited.exr")
    for name, off, value, want in EDITS["edits"]:
        if name != fn:
            continue
        with open(p, "wb") as f:
            f.write(gen_exr.edited(FILES[fn], off, value))
        try:
            got = hashlib.sha256(tio.read_image(p)[0].tobytes()).hexdigest()
        except ValueError:
            got = "refused"
        assert got == (want if len(want) == 64 else "refused"), (off, value)
