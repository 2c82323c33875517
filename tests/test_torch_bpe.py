"""The port's BPE surface against the JAX package's: training a vocabulary,
writing it, and the strand encoders and decoder, on both of the port's
engines (native C++ and Python). Everything must be equal, exactly."""

import numpy as np
import pytest

from variantformer_tpu.utils import bpe as jax_bpe
from variantformer_tpu_torch.utils import bpe


def _corpus(seed=0, n=40):
    """DNA with N runs, lower case and IUPAC codes: the normalizer's cases."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        seq = "".join(rng.choice(list("ACGT"), rng.integers(20, 200)))
        cut = rng.integers(1, len(seq) - 1)
        seq = seq[:cut] + "N" * int(rng.integers(1, 4)) + seq[cut:].lower()
        out.append(seq + "R")
    return out


@pytest.mark.parametrize("vocab_size,min_frequency", [(60, 2), (200, 1), (1000, 3)])
def test_train_bpe_matches_jax(vocab_size, min_frequency):
    corpus = _corpus()
    vocab, merges = bpe.train_bpe(corpus, vocab_size, min_frequency)
    want_vocab, want_merges = jax_bpe.train_bpe(corpus, vocab_size, min_frequency)
    assert vocab == want_vocab
    assert merges == want_merges
    assert len(vocab) <= vocab_size
    assert list(vocab)[:4] == ["<pad>", "<s>", "</s>", "<unk>"]


def test_save_vocabulary_bytes_match_jax(tmp_path):
    vocab, merges = bpe.train_bpe(_corpus(1), 120)
    bpe.save_vocabulary(str(tmp_path / "port.json"), vocab, merges)
    jax_bpe.save_vocabulary(str(tmp_path / "jax.json"), vocab, merges)
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    tok = bpe.BPETokenizer.from_file(str(tmp_path / "port.json"), use_native=False)
    assert tok.vocab == vocab


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "python"])
def test_encoders_and_decode_match_jax(use_native, tmp_path):
    vocab, merges = bpe.train_bpe(_corpus(2), 150)
    path = str(tmp_path / "vocab.json")
    bpe.save_vocabulary(path, vocab, merges)
    ours = bpe.BPETokenizer.from_file(path, use_native=use_native)
    theirs = jax_bpe.BPETokenizer(vocab, merges, use_native=False)
    for seq in _corpus(3, n=10):
        rev = seq[::-1]
        subs = ours.normalize([seq])
        assert ours.encode_strand(subs) == theirs.encode_strand(subs)
        assert ours.encode([seq, rev]) == theirs.encode([seq, rev])
        assert ours.encode(f"{seq},{rev}") == theirs.encode(f"{seq},{rev}")
        ids = ours.encode([seq, rev])[0]
        assert ours.decode(ids) == theirs.decode(ids) == "".join(subs)
        assert ours.decode([0, 1, 2, 3] + ids) == ours.decode(ids)


def test_default_tokenizer_matches_jax(tmp_path):
    ours, theirs = bpe.default_tokenizer(), jax_bpe.default_tokenizer()
    assert ours is bpe.default_tokenizer()
    assert len(ours.vocab) == 500 and ours.vocab == theirs.vocab
    assert ours.merge_ranks == theirs.merge_ranks
    seq = "".join(np.random.default_rng(4).choice(list("ACGTN"), 3000))
    np.testing.assert_array_equal(ours.encode_ids(seq), theirs.encode_ids(seq))
    assert ours.encode([seq, seq[::-1]]) == theirs.encode([seq, seq[::-1]])
    vocab, merges = bpe.train_bpe(_corpus(5), 80)
    bpe.save_vocabulary(str(tmp_path / "v.json"), vocab, merges)
    other = bpe.default_tokenizer(str(tmp_path / "v.json"))
    assert other.vocab == vocab and bpe.default_tokenizer() is ours
