"""CLIP's text tower and tokenizer in the port against the JAX package.

The BPE vocabulary (``bpe_simple_vocab_16e6.txt.gz``) is not in the
repository, so the tokenizer runs on a small merges file that the test
writes (``utils/drawn_weights.write_merges``). Tolerances: token ids
equal; the text encoder's embeddings within 1e-5 of their scale (the same
f32 arithmetic in another order), its weights a converted CLIP text tower
drawn in fp16.
"""

import jax
import numpy as np
import pytest
import torch

from isegprobe_torch.models import convert as P
from isegprobe_torch.utils import drawn_weights as D

torch.set_num_threads(2)

TOL = 1e-5
WORDS = ("photo", "of", "cat", "dog", "the", "café", "naïve", "fine", "it's",
         "ﬁne")
TEXTS = [
    "a photo of a cat",
    "A  Photo\tOF the DOG!!",
    "“curly” ‘quotes’ and the ﬁne ﬂow",  # quotes and ligatures
    "café naïve 東京 ＡＢＣ",  # accents, CJK, full-width forms
    "it's &amp; &lt;b&gt; html",
    "<|startoftext|> inside <|endoftext|>",
    "line\r\nbreaks\x0cand\x1b[31mcolour\x1b[0m",
    "",
    " ".join(["cat"] * 100),  # longer than the context
]


@pytest.fixture
def merges(tmp_path):
    return D.write_merges(tmp_path / "merges.txt.gz", WORDS)


def test_tokenizer_ids_match_jax(merges):
    from isegprobe_torch.models.featurizers.clip_tokenizer import \
        ClipTokenizer
    from isegprobe_tpu.models.featurizers.clip_tokenizer import \
        ClipTokenizer as JTok

    tok, jtok = ClipTokenizer(str(merges)), JTok(str(merges))
    assert tok.encoder == jtok.encoder and (tok.sot, tok.eot) == (jtok.sot,
                                                                  jtok.eot)
    got, want = tok(TEXTS), jtok(TEXTS)
    assert got.dtype == np.int32 and got.shape == (len(TEXTS), 77)
    np.testing.assert_array_equal(got, want)
    for text in TEXTS:
        assert tok.encode(text) == jtok.encode(text)
        assert tok.clean(text) == jtok.clean(text)
    assert tok.decode(tok.encode("a photo of a cat")) == "a photo of a cat "
    # the merges spell whole words; the eot closes every row, at its argmax
    assert tok.encode("photo") == [tok.encoder["photo</w>"]]
    assert (got.argmax(-1) == [int(np.flatnonzero(r == tok.eot)[0])
                               for r in got]).all()
    with pytest.raises(ValueError, match="tokenizes to"):
        tok(TEXTS[-1], truncate=False)


def test_offline_text_fix_matches_jax():
    from isegprobe_torch.models.featurizers.clip_tokenizer import (
        fix_text_offline,
    )
    from isegprobe_tpu.models.featurizers.clip_tokenizer import (
        fix_text_offline as jfix,
    )

    for text in TEXTS + ["\ud800 lone", "ﬃ ＨＥＬＬＯ"]:
        assert fix_text_offline(text) == jfix(text)


def test_text_encoder_matches_jax(merges):
    """2 layers, width 64, 4 heads, a 600-token vocabulary and a context of
    77, on a converted fp16 text tower; the embedding read at each row's
    end of text."""
    from isegprobe_torch.models.featurizers.clip_tokenizer import \
        ClipTokenizer
    from isegprobe_torch.models.featurizers.maskclip import CLIPTextEncoder
    from isegprobe_tpu.models.featurizers.maskclip import \
        CLIPTextEncoder as JText

    arch = dict(width=64, heads=4, layers=2, vocab_size=600,
                context_length=77, output_dim=32)
    sd = D.draw_state_dict(D.clip_layout(
        layers=1, width=32, grid=2, output_dim=32, text_layers=2,
        text_width=64, vocab=600, context=77), 5, torch.float16)
    tree = P.convert_clip_text(sd, 2)
    ids = ClipTokenizer(str(merges))(TEXTS)
    assert ids.max() < 600
    want = np.asarray(jax.jit(JText(**arch).apply)({"params": tree}, ids))
    model = P.load_jax_params(CLIPTextEncoder(**arch), tree)
    with torch.no_grad():
        got = model(torch.from_numpy(ids)).numpy()
    assert got.dtype == np.float32 and got.shape == (len(TEXTS), 32)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * float(np.abs(want).max()))
    # causal: a row's embedding ignores what follows its end of text
    ids2 = ids.copy()
    ids2[0, int(ids[0].argmax()) + 1:] = 7
    with torch.no_grad():
        again = model(torch.from_numpy(ids2)).numpy()
    np.testing.assert_allclose(again[0], got[0], rtol=0,
                               atol=TOL * float(np.abs(got).max()))
