"""The port's C++ batch image preprocessor (llavamod_tpu_torch/native) against
the JAX package's (llavamod_tpu/native), on the CPU:

  * port native vs JAX native, bitwise, on tests/test_native_prep.py's
    shapes, for both `image_aspect_ratio` values and the CLIP and SigLIP
    mean / std;
  * with LLAVAMOD_NO_NATIVE=1, the port's PIL path vs the JAX package's PIL
    path, bitwise;
  * a missing compiler raises (no quiet fallback), naming the switch;
  * the counters of the path each batch took;
  * the library is built into build/llavamod_tpu_torch/ at the repository
    root, named by a hash of the source and the flags, never beside the
    source."""

import os

import numpy as np
import pytest
from PIL import Image

from llavamod_tpu import mm_utils as jmm
from llavamod_tpu import native as jnative
from llavamod_tpu_torch import mm_utils as tmm
from llavamod_tpu_torch import native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MEANS = {"clip": (tmm.CLIP_IMAGE_MEAN, tmm.CLIP_IMAGE_STD),
         "siglip": (tmm.SIGLIP_IMAGE_MEAN, tmm.SIGLIP_IMAGE_STD)}


@pytest.fixture(scope="module")
def imgs():
    rng = np.random.default_rng(0)
    return [Image.fromarray(rng.integers(0, 255, size=(h, w, 3),
                                         dtype=np.uint8))
            for h, w in [(48, 64), (36, 36), (23, 41), (97, 55)]]


@pytest.fixture
def fresh_counts():
    native.reset_counts()
    yield native.counts
    native.reset_counts()


def _pair(aspect, norm, size=36):
    mean, std = MEANS[norm]
    kw = dict(size=size, image_aspect_ratio=aspect, mean=mean, std=std)
    return jmm.ImagePreprocessor(**kw), tmm.ImagePreprocessor(**kw)


@pytest.mark.parametrize("norm", ["clip", "siglip"])
@pytest.mark.parametrize("aspect", [None, "pad"])
def test_native_is_bitwise_the_jax_native(imgs, aspect, norm, fresh_counts):
    assert jnative.is_available()
    jpp, tpp = _pair(aspect, norm)
    want = jpp._native_batch(imgs)
    got = tpp(imgs)
    assert got.dtype == np.float32 and got.shape == (4, 3, 36, 36)
    np.testing.assert_array_equal(got, want)
    assert fresh_counts == {"native": 1, "pil": 0}
    # an image in another mode is converted to RGB first, as in JAX
    gray = [im.convert("L") for im in imgs[:2]]
    np.testing.assert_array_equal(tpp(gray), jpp._native_batch(gray))


@pytest.mark.parametrize("aspect", [None, "pad"])
def test_pil_path_is_bitwise_the_jax_pil_path(imgs, aspect, monkeypatch,
                                              fresh_counts):
    monkeypatch.setenv("LLAVAMOD_NO_NATIVE", "1")
    jpp, tpp = _pair(aspect, "clip")
    want = np.stack([jpp.preprocess_one(im) for im in imgs])
    got = tpp(imgs)
    np.testing.assert_array_equal(got, want)
    assert fresh_counts == {"native": 0, "pil": 1}
    # the two paths differ (PIL rounds each resample pass to uint8)
    monkeypatch.delenv("LLAVAMOD_NO_NATIVE")
    assert not np.array_equal(tpp(imgs), got)
    assert fresh_counts == {"native": 1, "pil": 1}


def test_a_missing_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path))      # no g++ on it
    with pytest.raises(RuntimeError, match="g.. not found.*LLAVAMOD_NO_NATIVE"):
        tmm.ImagePreprocessor(size=8)(Image.new("RGB", (8, 8)))
    assert not (tmp_path / "build").exists()


def test_a_failed_build_raises_with_the_compiler_output(tmp_path,
                                                        monkeypatch):
    bad = tmp_path / "image_prep.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*error:"):
        native.load_library()
    assert not list((tmp_path / "build").glob("*.so"))


def test_the_library_is_built_under_build(imgs, monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    tmm.ImagePreprocessor(size=12)(imgs[:1])
    path = native.library_path(native._cxx())
    assert str(path.parent) == os.path.join(REPO, "build",
                                            "llavamod_tpu_torch")
    assert path.exists() and path.name.startswith("libimageprep_")
    src_dir = os.path.dirname(native.SRC)
    assert not [f for f in os.listdir(src_dir) if f.endswith(".so")]
    # the name follows the source and the flags
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ("-g",))
    assert native.library_path(native._cxx()) != path


def test_a_bad_image_raises():
    with pytest.raises(ValueError, match="HWC RGB"):
        native.preprocess_batch([np.zeros((4, 4), np.uint8)], 4,
                                pad_square=False, background=(0, 0, 0),
                                mean=(0.5,) * 3, std=(0.5,) * 3)
