"""Calibration and evaluation token sets as int32 ``[n_sample, seqlen]``.

The port's own copy of the JAX package's ``evaluation/data.py`` (numpy
only), with the same join / shuffle / chunk semantics:

* wikitext2 test: all lines joined with ``"\\n\\n"``, tokenized once,
  truncated to a multiple of seqlen; train: a seeded ``datasets`` shuffle,
  the first ``n_sample`` rows joined and re-chunked,
* c4 validation: the first 1100 documents joined by a space, capped at
  ``256 * seqlen`` tokens; train: a seeded shuffle of the first shard,
* pileval: seed-42 shuffle, lines over 512 tokens skipped,
* ``local:<path>``: a text file with the wikitext2 semantics,
* ``synthetic``: a seeded Zipf-like stream for runs without corpus files.

``datasets`` is imported only by the loaders that need it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def synthetic_tokens(vocab_size: int, n_sample: int = 8, seqlen: int = 128,
                     seed: int = 0) -> np.ndarray:
    """Deterministic Zipf-like token stream with short-range repeats."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    probs = 1.0 / ranks
    probs /= probs.sum()
    flat = rng.choice(vocab_size, size=n_sample * seqlen, p=probs)
    rep = rng.random(flat.shape) < 0.3
    flat[1:][rep[1:]] = flat[:-1][rep[1:]]
    return flat.reshape(n_sample, seqlen).astype(np.int32)


def _chunk(token_ids: np.ndarray, seqlen: int) -> np.ndarray:
    n = token_ids.size // seqlen
    return token_ids[: n * seqlen].reshape(n, seqlen).astype(np.int32)


def _require_datasets():
    try:
        import datasets
    except ImportError as e:
        raise RuntimeError("the `datasets` package is needed to load this "
                           "corpus and is not installed; use --dataset "
                           "synthetic or local:<text file>") from e
    return datasets


def get_wikitext2(tokenizer, seqlen: int = 2048, train: bool = False,
                  seed: int = 0, n_sample: int = 128,
                  cache_dir: Optional[str] = None) -> np.ndarray:
    datasets = _require_datasets()
    split = "train" if train else "test"
    d = datasets.load_dataset("wikitext", "wikitext-2-raw-v1", split=split,
                              cache_dir=cache_dir)
    if train:
        text = "\n\n".join(d.shuffle(seed=seed)[:n_sample]["text"])
    else:
        text = "\n\n".join(d["text"])
    ids = np.asarray(tokenizer(text, return_tensors="np").input_ids[0])
    return _chunk(ids, seqlen)


def get_c4(tokenizer, seqlen: int = 2048, train: bool = False, seed: int = 0,
           n_sample: int = 128, cache_dir: Optional[str] = None) -> np.ndarray:
    datasets = _require_datasets()
    if train:
        d = datasets.load_dataset(
            "allenai/c4",
            data_files={"train": "en/c4-train.00000-of-01024.json.gz"},
            split="train", cache_dir=cache_dir)
        text = " ".join(d.shuffle(seed=seed)[:n_sample]["text"])
        ids = np.asarray(tokenizer(text, return_tensors="np").input_ids[0])
        return _chunk(ids, seqlen)
    d = datasets.load_dataset(
        "allenai/c4",
        data_files={"validation": "en/c4-validation.00000-of-00008.json.gz"},
        split="validation", cache_dir=cache_dir)
    ids = np.asarray(tokenizer(" ".join(d[:1100]["text"]),
                               return_tensors="np").input_ids[0])
    return _chunk(ids[: 256 * seqlen], seqlen)


def get_pileval(tokenizer, block_size: int = 512, n_lines: int = 512,
                seed: int = 42,
                cache_dir: Optional[str] = None) -> np.ndarray:
    datasets = _require_datasets()
    d = datasets.load_dataset("mit-han-lab/pile-val-backup",
                              split="validation", cache_dir=cache_dir)
    parts = []
    for row in d.shuffle(seed=seed):
        enc = np.asarray(tokenizer.encode(row["text"].strip()))
        if enc.size == 0 or enc.size > 512:
            continue
        parts.append(enc)
        if len(parts) == n_lines:
            break
    return _chunk(np.concatenate(parts), block_size)


def get_local_text(path: str, tokenizer, seqlen: int = 2048,
                   train: bool = False, seed: int = 0,
                   n_sample: int = 128) -> np.ndarray:
    with open(path) as f:
        lines = f.read().splitlines()
    if train:
        order = np.random.default_rng(seed).permutation(len(lines))[:n_sample]
        text = "\n\n".join(lines[i] for i in order)
    else:
        text = "\n\n".join(lines)
    ids = np.asarray(tokenizer(text, return_tensors="np").input_ids[0])
    return _chunk(ids, seqlen)


def get_loader(name: str, tokenizer=None, n_sample: int = 128,
               train: bool = True, seed: int = 0, seqlen: int = 2048,
               cache_dir: Optional[str] = None,
               synthetic_vocab: Optional[int] = None) -> np.ndarray:
    if name == "synthetic":
        if synthetic_vocab is None:
            raise ValueError("the synthetic dataset needs synthetic_vocab")
        return synthetic_tokens(synthetic_vocab, n_sample=n_sample,
                                seqlen=seqlen, seed=seed)
    if name.startswith("local:"):
        toks = get_local_text(name[len("local:"):], tokenizer, seqlen=seqlen,
                              train=train, seed=seed, n_sample=n_sample)
        return toks[:n_sample] if train else toks
    if name == "pileval":
        return get_pileval(tokenizer, block_size=seqlen, cache_dir=cache_dir)
    if "wikitext2" in name:
        return get_wikitext2(tokenizer, seqlen=seqlen, train=train, seed=seed,
                             n_sample=n_sample, cache_dir=cache_dir)
    if "c4" in name:
        return get_c4(tokenizer, seqlen=seqlen, train=train, seed=seed,
                      n_sample=n_sample, cache_dir=cache_dir)
    raise ValueError(f"unknown dataset {name!r}")
