"""The port's data layer against the JAX package's (CPU, no card): the
corpora (``data/datasets.py``: the synthetic streams, the pg19 / c4 / wiki /
cnn converters with and without their files, ``batch_iterator``), each
RULER task's rows, ``write_jsonl``'s bytes and ``score_row``
(``data/ruler/synthetic.py``), ``prepare_ruler``'s file, and
``native.window_pack`` / ``tile_windows`` against
``magicdec_tpu.native`` (0 windows, no BOS, repeats), bit for bit."""

import json

import numpy as np
import pytest

from magicdec_tpu.data import datasets as JD
from magicdec_tpu.data.ruler import synthetic as JR
from magicdec_tpu_torch import native
from magicdec_tpu_torch.data import datasets as D
from magicdec_tpu_torch.data.ruler import synthetic as R


class Tok:
    """tests/test_data.py's stub tokenizer: a token a character."""
    vocab_size = 500
    bos_token_id = 2

    def encode(self, text):
        return [min(ord(c), 499) for c in text]


class TokNoBos(Tok):
    bos_token_id = None


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed,bos", [(0, 1), (7, None), (123, 5)])
def test_synthetic_corpus_matches_jax(seed, bos):
    kw = dict(num_seqs=5, vocab_size=1000, seed=seed, bos_id=bos)
    _same(D.synthetic_long_context_dataset(300, **kw), JD.synthetic_long_context_dataset(300, **kw))


@pytest.mark.parametrize("tok", [Tok(), TokNoBos()], ids=["bos", "no_bos"])
def test_pg19_matches_jax(tmp_path, tok):
    missing = str(tmp_path / "missing")
    _same(D.convert_pg19_dataset(tok, 128, data_dir=missing),
          JD.convert_pg19_dataset(tok, 128, data_dir=missing))
    books = tmp_path / "pg19"
    books.mkdir()
    for i, text in enumerate(["ab" * 5000, "xyz" * 40, "hello world " * 900]):
        (books / f"book{i}.json").write_text(json.dumps({"text": text}))
    (books / "raw.json").write_text(json.dumps("q" * 700))
    for kw in (dict(drop_prefix=100, repeats=2), dict(books=2, drop_prefix=0, repeats=1)):
        _same(D.convert_pg19_dataset(tok, 64, data_dir=str(books), **kw),
              JD.convert_pg19_dataset(tok, 64, data_dir=str(books), **kw))


def test_c4_wiki_cnn_match_jax(tmp_path):
    tok = Tok()
    for port, ref in ((D.convert_c4_dataset, JD.convert_c4_dataset),
                      (D.convert_wiki_dataset, JD.convert_wiki_dataset),
                      (D.convert_cnn_dataset, JD.convert_cnn_dataset)):
        path = str(tmp_path / "missing.json")
        _same(port(tok, 96, path), ref(tok, 96, path))
    c4 = tmp_path / "c4.json"
    c4.write_text("\n".join(json.dumps({"text": t}) for t in ["abc" * 100, "", "zz" * 80])
                  + "\n\n")
    _same(D.convert_c4_dataset(tok, 32, str(c4)), JD.convert_c4_dataset(tok, 32, str(c4)))
    txt = tmp_path / "wiki.txt"
    txt.write_text("the quick brown fox " * 50)
    for port, ref in ((D.convert_wiki_dataset, JD.convert_wiki_dataset),
                      (D.convert_cnn_dataset, JD.convert_cnn_dataset)):
        _same(port(tok, 48, str(txt)), ref(tok, 48, str(txt)))
    assert len(D.convert_wiki_dataset(tok, 48, None)) == 32


@pytest.mark.parametrize("max_windows", [None, 1, 3, 100])
def test_dataset_from_texts_matches_jax(max_windows):
    texts = ["a" * 50, "bc" * 10, "d" * 130]
    for tok in (Tok(), TokNoBos()):
        _same(D._dataset_from_texts(texts, tok, 16, drop_prefix=3, repeats=2,
                                    max_windows=max_windows),
              JD._dataset_from_texts(texts, tok, 16, drop_prefix=3, repeats=2,
                                     max_windows=max_windows))
    _same(D._dataset_from_texts(["x"], Tok(), 16), JD._dataset_from_texts(["x"], Tok(), 16))


def test_batch_iterator_matches_jax():
    data = np.arange(70, dtype=np.int32).reshape(10, 7)
    for bs in (1, 3, 4, 10, 11):
        port, ref = list(D.batch_iterator(data, bs)), list(JD.batch_iterator(data, bs))
        assert len(port) == len(ref)
        for a, b in zip(port, ref):
            _same(a, b)


RULER_KW = {"niah_single": dict(context_words=300), "niah_multikey": dict(context_words=300),
            "variable_tracking": dict(context_words=200),
            "common_words_extraction": dict(num_lists=6),
            "freq_words_extraction": dict(stream_len=120), "qa": dict(context_words=240)}


@pytest.mark.parametrize("task", sorted(JR.TASKS))
def test_ruler_rows_match_jax(task, tmp_path):
    assert sorted(R.TASKS) == sorted(JR.TASKS)
    for seed in (42, 7):
        kw = dict(num_samples=3, seed=seed, **RULER_KW[task])
        rows, ref = list(R.TASKS[task](**kw)), list(JR.TASKS[task](**kw))
        assert rows == ref
        assert json.dumps(rows) == json.dumps(ref)
    kw = dict(num_samples=2, **RULER_KW[task])
    assert R.write_jsonl(task, str(tmp_path / "p.jsonl"), **kw) == 2
    assert JR.write_jsonl(task, str(tmp_path / "j.jsonl"), **kw) == 2
    assert (tmp_path / "p.jsonl").read_bytes() == (tmp_path / "j.jsonl").read_bytes()


def test_score_row_matches_jax():
    rows = list(R.generate_niah(num_samples=2, context_words=100, num_needles=3,
                                num_queries=2)) + [{"outputs": []}]
    for row in rows:
        outs = row["outputs"]
        for pred in ("", "nothing", " ".join(outs), (outs[0].upper() if outs else "x"),
                     " ".join(outs[:1])):
            assert R.score_row(row, pred) == JR.score_row(row, pred)


@pytest.mark.parametrize("task,extra", [("niah_single", ["--context_words", "300"]),
                                        ("freq_words_extraction", ["--context_words", "9"]),
                                        ("qa", ["--seed", "3"])])
def test_prepare_ruler_file_matches_jax(task, extra, tmp_path, capsys):
    from magicdec_tpu_torch import prepare_ruler

    out = tmp_path / "rows.jsonl"
    r = prepare_ruler.main(["--task", task, "--out", str(out), "--num_samples", "3"] + extra)
    assert r == {"path": str(out), "samples": 3}
    assert capsys.readouterr().out.strip() == f"wrote 3 samples to {out}"
    args = prepare_ruler.parse_args(["--task", task, "--out", "x"] + extra)
    kw = dict(num_samples=3, seed=args.seed)
    if "words_extraction" not in task:
        kw["context_words"] = args.context_words
    JR.write_jsonl(task, str(tmp_path / "ref.jsonl"), **kw)
    assert out.read_bytes() == (tmp_path / "ref.jsonl").read_bytes()


@pytest.mark.parametrize("n,seq_len,bos,repeats", [
    (10_000, 128, 7, 3), (512, 256, None, 1), (513, 256, 0, 2), (100, 128, 1, 1),
    (100, 128, None, 4), (0, 16, 3, 1), (37, 37, 5, 1), (64, 1, None, 2)])
def test_window_pack_matches_jax(n, seq_len, bos, repeats):
    from magicdec_tpu import native as jnative

    tokens = np.random.RandomState(n).randint(0, 1000, size=n).astype(np.int32)
    _same(native.window_pack(tokens, seq_len, bos, repeats=repeats),
          jnative.window_pack(tokens, seq_len, bos, repeats=repeats))


def test_window_pack_nonpositive_seq_len_and_tiling():
    """seq_len <= 0 gives 0 windows, as ``runtime.cpp md_window_pack`` (its
    Python wrapper divides by seq_len first); ``tile_windows`` is
    ``md_tile_windows``."""
    import ctypes

    from magicdec_tpu import native as jnative

    tokens = np.arange(64, dtype=np.int32)
    lib = jnative._load()
    assert lib is not None, "g++ toolchain expected in this image"
    p = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))  # noqa: E731
    out = np.zeros((4, 16), np.int32)
    for seq_len in (0, -3):
        assert lib.md_window_pack(p(tokens), len(tokens), seq_len, 1, p(out), 4) == 0
        assert native.window_pack(tokens, seq_len, 1).shape[0] == 0
    windows = np.random.RandomState(1).randint(0, 99, size=(3, 8)).astype(np.int32)
    for reps in (1, 2, 5):
        ref = np.empty((3 * reps, 8), np.int32)
        lib.md_tile_windows(p(windows), 3, 8, reps, p(ref))
        _same(native.tile_windows(windows, reps), ref)
