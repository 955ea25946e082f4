"""Dataset converters (counterpart of magicdec_tpu/data/datasets.py, the
same windows for the same inputs).

The windowing contract of the reference's ``convert_pg19_dataset``: take
the first ``books`` documents, tokenize, drop a prefix, split into
``seq_len`` windows, force BOS at window position 0, tile ``repeats``
times.  Returns numpy int32 [N, seq_len].

Every loader falls back to :func:`synthetic_long_context_dataset` when its
source files are missing, so a driver measures the same compute on
synthetic token streams where no corpus is on disk.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Iterable, List, Optional

import numpy as np


def _window(tokens: np.ndarray, seq_len: int, bos_id: Optional[int]) -> np.ndarray:
    n = len(tokens) // seq_len
    if n == 0:
        return np.empty((0, seq_len), np.int32)
    out = tokens[: n * seq_len].reshape(n, seq_len).astype(np.int32).copy()
    if bos_id is not None:
        out[:, 0] = bos_id  # BOS forced at each window's start
    return out


def _dataset_from_texts(texts: Iterable[str], tokenizer, seq_len: int,
                        drop_prefix: int = 0, repeats: int = 1,
                        max_windows: Optional[int] = None) -> np.ndarray:
    bos = getattr(tokenizer, "bos_token_id", None)
    windows: List[np.ndarray] = []
    for text in texts:
        ids = np.asarray(tokenizer.encode(text), np.int32)
        ids = ids[drop_prefix:]
        w = _window(ids, seq_len, bos)
        if len(w):
            windows.append(w)
        if max_windows and sum(len(w) for w in windows) >= max_windows:
            break
    if not windows:
        return np.empty((0, seq_len), np.int32)
    data = np.concatenate(windows)[:max_windows]
    return np.tile(data, (repeats, 1))


def convert_pg19_dataset(tokenizer, seq_len: int, data_dir: str = "Data/pg19",
                         books: int = 50, drop_prefix: int = 8000,
                         repeats: int = 20) -> np.ndarray:
    """PG-19 windows from ``data_dir/*.json`` (``{"text": ...}`` a book).
    Without the files: ``synthetic_long_context_dataset(num_seqs=books,
    seed=0)`` at the tokenizer's vocabulary size and BOS id."""
    paths = sorted(glob.glob(os.path.join(data_dir, "*.json")))[:books]
    if not paths:
        vocab = getattr(tokenizer, "vocab_size", 32000)
        return synthetic_long_context_dataset(seq_len, num_seqs=books, vocab_size=vocab,
                                              bos_id=getattr(tokenizer, "bos_token_id", None))
    texts = []
    for p in paths:
        with open(p) as f:
            doc = json.load(f)
        texts.append(doc["text"] if isinstance(doc, dict) else str(doc))
    return _dataset_from_texts(texts, tokenizer, seq_len, drop_prefix=drop_prefix,
                               repeats=repeats)


def convert_c4_dataset(tokenizer, seq_len: int,
                       json_path: str = "Data/c4_small.json") -> np.ndarray:
    """C4 windows from a JSON-lines file (``{"text": ...}`` a row); without
    it, 64 synthetic sequences."""
    if not os.path.exists(json_path):
        return synthetic_long_context_dataset(
            seq_len, num_seqs=64, vocab_size=getattr(tokenizer, "vocab_size", 32000),
            bos_id=getattr(tokenizer, "bos_token_id", None))
    with open(json_path) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    texts = [r.get("text", "") for r in rows]
    return _dataset_from_texts(texts, tokenizer, seq_len)


def convert_wiki_dataset(tokenizer, seq_len: int, path: Optional[str] = None) -> np.ndarray:
    """Windows of one local text file; without it, 32 synthetic sequences."""
    if path is None or not os.path.exists(path):
        return synthetic_long_context_dataset(
            seq_len, num_seqs=32, vocab_size=getattr(tokenizer, "vocab_size", 32000),
            bos_id=getattr(tokenizer, "bos_token_id", None))
    with open(path) as f:
        return _dataset_from_texts([f.read()], tokenizer, seq_len)


def convert_cnn_dataset(tokenizer, seq_len: int, path: Optional[str] = None) -> np.ndarray:
    """CNN / DailyMail windows: a local text file, as ``convert_wiki_dataset``."""
    return convert_wiki_dataset(tokenizer, seq_len, path)


def synthetic_long_context_dataset(seq_len: int, num_seqs: int = 32, vocab_size: int = 32000,
                                   seed: int = 0, bos_id: Optional[int] = 1) -> np.ndarray:
    """Structured synthetic token streams: repeated 16-token motifs (70%)
    mixed with random runs, so a compressed draft cache sees realistic
    locality."""
    rng = np.random.RandomState(seed)
    motifs = rng.randint(0, vocab_size, size=(64, 16))
    out = np.empty((num_seqs, seq_len), np.int32)
    for i in range(num_seqs):
        stream: List[np.ndarray] = []
        n = 0
        while n < seq_len:
            if rng.rand() < 0.7:
                m = motifs[rng.randint(len(motifs))]
            else:
                m = rng.randint(0, vocab_size, size=16)
            stream.append(m)
            n += len(m)
        out[i] = np.concatenate(stream)[:seq_len]
    if bos_id is not None:
        out[:, 0] = bos_id
    return out


def batch_iterator(data: np.ndarray, batch_size: int):
    """Consecutive batches of ``batch_size`` rows, no shuffle, the last
    partial batch dropped."""
    n = len(data) // batch_size
    for i in range(n):
        yield data[i * batch_size:(i + 1) * batch_size]
