"""The port's own copies of the JAX package's host modules (constants,
conversation, mm_utils, data/splice, utils/registry) against their
originals on the same inputs: every chat template renders the same prompt,
image-aware tokenization and the image-slot splice (left and right
padding) give the same arrays, and the image preprocessor gives the same
pixels (the JAX one on its C++ path from tests/test_torch_native_prep.py's
`jax_native` build)."""

import dataclasses

import numpy as np
import pytest
from PIL import Image

from llavamod_tpu import constants as jconst
from llavamod_tpu import conversation as jconv
from llavamod_tpu import mm_utils as jmm
from llavamod_tpu.data import splice as jsplice
from llavamod_tpu.utils.registry import Registry as JRegistry
from llavamod_tpu_torch import constants as tconst
from llavamod_tpu_torch import conversation as tconv
from llavamod_tpu_torch import mm_utils as tmm
from llavamod_tpu_torch.data import splice as tsplice
from llavamod_tpu_torch.utils.registry import Registry
from test_torch_native_prep import jax_native  # noqa: F401


class _Tok:
    """Deterministic word-level ids with a leading BOS."""
    bos_token_id = 1

    def __call__(self, text):
        ids = [1] + [2 + (sum(map(ord, w)) % 97) for w in text.split()]
        return type("Enc", (), {"input_ids": ids})()


def test_constants_are_the_same():
    names = [n for n in dir(jconst) if n.isupper()]
    assert names and all(getattr(tconst, n) == getattr(jconst, n)
                         for n in names)


@pytest.mark.parametrize("name", sorted(jconv.conv_templates))
def test_every_template_renders_the_same(name):
    j, t = jconv.get_template(name), tconv.get_template(name)
    for conv in (j, t):
        conv.append(conv.roles[0], "<image>\nWhat is shown?")
        conv.append(conv.roles[1], "A cat.")
        conv.append(conv.roles[0], "And the colour?")
        conv.append(conv.roles[1], None)
    assert t.render() == j.render()
    assert t.stop_str() == j.stop_str()
    assert tconv.infer_template_name(name) == jconv.infer_template_name(name)


@pytest.mark.parametrize("pad_side", ["left", "right"])
def test_tokenize_and_splice_are_the_same(pad_side):
    prompt = "USER: <image>\nWhat is in <image> and here? ASSISTANT: two"
    tok = _Tok()
    ids_j = jmm.tokenize_with_images(prompt, tok)
    ids_t = tmm.tokenize_with_images(prompt, tok)
    assert ids_t == ids_j and ids_j.count(jconst.IMAGE_TOKEN_INDEX) == 2
    labels = [jconst.IGNORE_INDEX] * 5 + ids_j[5:]
    kw = dict(num_image_tokens=4, max_len=32, max_images=2,
              pad_side=pad_side)
    sj = jsplice.expand_image_tokens(ids_j, labels, **kw)
    st = tsplice.expand_image_tokens(ids_t, labels, **kw)
    for f in dataclasses.fields(sj):
        np.testing.assert_array_equal(getattr(st, f.name),
                                      getattr(sj, f.name), err_msg=f.name)


@pytest.mark.usefixtures("jax_native")
@pytest.mark.parametrize("aspect", [None, "pad"])
def test_image_preprocessor_is_the_same(aspect):
    rng = np.random.RandomState(5)
    img = Image.fromarray(rng.randint(0, 256, (50, 37, 3), dtype=np.uint8))
    kw = dict(size=28, image_aspect_ratio=aspect)
    # both packages' calls take their C++ batch path
    want = jmm.ImagePreprocessor(**kw)(img)
    got = tmm.ImagePreprocessor(**kw)(img)
    assert got.shape == (1, 3, 28, 28)
    np.testing.assert_array_equal(got, want)
    # and the PIL path image by image
    np.testing.assert_array_equal(tmm.ImagePreprocessor(**kw).preprocess_one(img),
                                  jmm.ImagePreprocessor(**kw).preprocess_one(img))


def test_registry_behaves_the_same():
    for cls in (Registry, JRegistry):
        r = cls("thing")
        r.register("a-b", 1, aliases=("ab",))
        assert r.get("a-b") == r.get("ab") == 1
        with pytest.raises(KeyError):
            r.get("missing")
