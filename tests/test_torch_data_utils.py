"""The port's native PNG decoder (``data/native_loader.py``, built from
``csrc/host/loader.cpp`` by g++ at first use), the numpy pipelines that
complete ``data/pipelines.py``, ``datasets.as_model_input`` and
``utils/visualize.py``, each against the JAX package on the CPU (and the
decoder against PIL), byte for byte.
"""

import numpy as np
import pytest
import torch
from PIL import Image

from fcvsr_tpu.data import datasets as JD
from fcvsr_tpu.data import native_loader as JNL
from fcvsr_tpu.data import pipelines as JP
from fcvsr_tpu.utils import visualize as JV
from fcvsr_tpu_torch.data import datasets as PD
from fcvsr_tpu_torch.data import native_loader as PNL
from fcvsr_tpu_torch.data import pipelines as PP
from fcvsr_tpu_torch.utils import visualize as PV


def equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# ---------------------------- the PNG decoder --------------------------------

@pytest.fixture(scope="module")
def pngs(tmp_path_factory):
    """PNGs written by PIL: 6 RGB frames of one size, and a grey, an RGBA
    and a grey+alpha image, with their arrays."""
    root = tmp_path_factory.mktemp("pngs")
    rng = np.random.default_rng(0)
    rgb = []
    for i in range(6):
        arr = rng.integers(0, 256, (24, 40, 3), dtype=np.uint8)
        path = str(root / f"rgb{i}.png")
        Image.fromarray(arr).save(path)
        rgb.append(path)
    modes = {"L": (26, 30), "RGBA": (26, 30, 4), "LA": (26, 30, 2)}
    other = {}
    for mode, shape in modes.items():
        arr = rng.integers(0, 256, shape, dtype=np.uint8)
        path = str(root / f"{mode}.png")
        Image.fromarray(arr, mode).save(path)
        other[mode] = path
    return rgb, other


def test_the_decoder_builds_here():
    """g++ and zlib are here: the library builds (under the package's
    ``_build/host``) and loads."""
    assert PNL.native_available()
    assert PNL.load_library() is PNL.load_library()
    assert PNL.lib_path().is_file()
    assert PNL.lib_path().parent.name == "host"


@pytest.mark.parametrize("mode", ["rgb", "L", "RGBA", "LA"])
@pytest.mark.parametrize("grayscale", [False, True])
def test_decode_matches_jax_and_pil(pngs, mode, grayscale):
    """One image, as RGB or as PIL's luma, equal to the JAX package's
    native decode and to PIL's."""
    rgb, other = pngs
    path = rgb[0] if mode == "rgb" else other[mode]
    got = PNL.load_image_native(path, grayscale)
    equal(got, JNL.load_image_native(path, grayscale))
    equal(got, PD.load_image(path, grayscale))
    assert got.shape[-1] == (1 if grayscale else 3)


@pytest.mark.parametrize("grayscale", [False, True])
def test_batch_decode_with_threads(pngs, grayscale):
    """6 frames by 3 threads, equal to the JAX decoder's batch and to PIL
    frame by frame."""
    rgb, _ = pngs
    got = PNL.load_batch_native(rgb, 24, 40, grayscale, num_threads=3)
    equal(got, JNL.load_batch_native(rgb, 24, 40, grayscale, num_threads=3))
    equal(got, np.stack([PD.load_image(p, grayscale) for p in rgb]))


def test_u8_to_f32_matches_jax():
    arr = np.random.default_rng(1).integers(0, 256, (3, 17, 19),
                                            dtype=np.uint8)
    got = PNL.u8_to_f32_native(arr)
    equal(got, JNL.u8_to_f32_native(arr))
    np.testing.assert_allclose(got, arr / 255.0, rtol=1e-6)


# ------------------------------- pipelines -----------------------------------

def test_pipelines_match_jax():
    """normalize (with the BGR flip), rescale_to_zero_one, temporal_reverse
    over one seed's draws, mirror_sequence and as_model_input."""
    rng = np.random.default_rng(2)
    u8 = rng.integers(0, 256, (5, 8, 9, 3), dtype=np.uint8)
    frames = u8.astype(np.float32) / 255
    mean, std = [0.4, 0.5, 0.6], [0.2, 0.25, 0.3]
    for to_rgb in (False, True):
        equal(PP.normalize(frames, mean, std, to_rgb),
              JP.normalize(frames, mean, std, to_rgb))
    equal(PP.rescale_to_zero_one(u8), JP.rescale_to_zero_one(u8))
    gt = frames[:, ::2]
    prng, jrng = np.random.default_rng(3), np.random.default_rng(3)
    flips = []
    for _ in range(6):
        got = PP.temporal_reverse(prng, frames, gt, reverse_ratio=0.5)
        want = JP.temporal_reverse(jrng, frames, gt, reverse_ratio=0.5)
        assert got[0] == want[0]
        flips.append(got[0])
        for g, w in zip(got[1:], want[1:]):
            equal(g, w)
    assert any(flips) and not all(flips)
    equal(PP.mirror_sequence(frames), JP.mirror_sequence(frames))
    equal(PD.as_model_input(u8), JD.as_model_input(u8))


# ------------------------------- visualize -----------------------------------

def test_visualize_matches_jax(tmp_path):
    """The colour wheel, flow pictures (clipped, BGR), feature maps (NCHW
    and NHWC arrays, and an NCHW tensor) and the comparison strip's PNG."""
    equal(PV.make_colorwheel(), JV.make_colorwheel())
    rng = np.random.default_rng(4)
    flow = rng.normal(0, 3, (12, 14, 2)).astype(np.float32)
    for kw in (dict(), dict(clip_flow=2.0), dict(convert_to_bgr=True)):
        equal(PV.flow_to_image(flow, **kw), JV.flow_to_image(flow, **kw))
    feat = rng.normal(size=(2, 6, 9, 11)).astype(np.float32)
    for kw in (dict(), dict(num_ch=3)):
        equal(PV.featuremap_visual(feat, **kw), JV.featuremap_visual(feat,
                                                                     **kw))
        nhwc = feat.transpose(0, 2, 3, 1)
        equal(PV.featuremap_visual(nhwc, layout="nhwc", **kw),
              JV.featuremap_visual(nhwc, layout="nhwc", **kw))
    equal(PV.featuremap_visual(torch.from_numpy(feat)),
          JV.featuremap_visual(feat))
    panels = [rng.uniform(-20, 275, (10, 12, c)) for c in (3, 1)]
    for c, panel in zip((3, 1), panels):
        for gt in (panel, None):
            PV.save_comparison(str(tmp_path / "p.png"), panel, panel * 0.5,
                               gt)
            JV.save_comparison(str(tmp_path / "j.png"), panel, panel * 0.5,
                               gt)
            equal(np.asarray(Image.open(tmp_path / "p.png")),
                  np.asarray(Image.open(tmp_path / "j.png")))
