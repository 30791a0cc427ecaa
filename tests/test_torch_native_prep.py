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
    source.

The JAX side's C++ path comes from `jax_native`, a module fixture that
tests/test_torch_data.py and tests/test_torch_host_copies.py use too.  The
JAX loader builds its library in place beside its source, non-atomically,
and remembers a failed load for the life of the process: pytest-xdist
workers that reach it together (tests/test_native_prep.py loads it at
collection) can dlopen a half-written file ("file too short") and then
fall back to PIL in every later test of that worker.  The fixture builds
the same source with the same command into a file private to the test
session, under an fcntl lock shared by the session's workers, moves it into
place with os.replace, and points the JAX loader at it."""

import fcntl
import os
import subprocess
import sys
import types

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


def _jax_build_command(out: str):
    """The JAX loader's own compiler command (`_build`: its source, its
    flags), writing `out` instead of the file beside the source."""
    seen = []
    recorder = types.SimpleNamespace(
        run=lambda cmd, **kw: seen.append(list(cmd)),
        SubprocessError=subprocess.SubprocessError)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "_LIB_PATH", out)
        mp.setattr(jnative, "subprocess", recorder)
        jnative._build()
    return seen[0]


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """The JAX package's C++ preprocessor, loaded from a build private to
    the test session (see the module docstring)."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent          # shared by the session's workers
    lib = root / f"jax-libimageprep-{sys.implementation.cache_tag}.so"
    with open(root / "jax-libimageprep.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not lib.exists():
            tmp = root / f"{lib.name}.{os.getpid()}.tmp"
            cmd = _jax_build_command(str(tmp))
            done = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
            if done.returncode:
                raise RuntimeError(f"{' '.join(cmd)} failed:\n"
                                   f"{done.stdout}{done.stderr}")
            os.replace(tmp, lib)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "_LIB_PATH", str(lib))
        mp.setattr(jnative, "_lib", None)
        mp.setattr(jnative, "_tried", False)
        mp.delenv("LLAVAMOD_NO_NATIVE", raising=False)
        if not jnative.is_available():
            raise RuntimeError(f"the JAX package's library {lib} does not "
                               "load (its loader printed why on stderr)")
        yield jnative


pytestmark = pytest.mark.usefixtures("jax_native")


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
