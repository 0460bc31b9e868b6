"""Deterministic synthetic datasets (numpy; a copy of ``repro.data.synthetic``).

``digits(...)`` — MNIST surrogate: 10 classes of 28x28 grayscale glyphs
rendered from seven-segment stroke templates with per-sample affine jitter,
stroke-intensity variation and Gaussian pixel noise.  Preserves what the
paper's experiments exercise (10-class image classification under label-skewed
client splits) while being fully deterministic from a seed.

``mnist_idx(...)`` — loader for the real MNIST idx files; the training
driver uses them when they are present under ``data/mnist/``.

``lm_tokens(...)`` — Zipf token sequences with a bigram twist for LM
pretraining, bit-identical to the reference's (numpy ``default_rng``).
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np

# --- seven-segment templates -------------------------------------------------
#   A
#  F B
#   G
#  E C
#   D
_SEGMENTS = {
    0: "ABCDEF", 1: "BC", 2: "ABGED", 3: "ABGCD", 4: "FGBC",
    5: "AFGCD", 6: "AFGECD", 7: "ABC", 8: "ABCDEFG", 9: "ABCFGD",
}
# segment -> (row0, col0, row1, col1) in a 24x14 glyph box (line endpoints)
_SEG_COORDS = {
    "A": (1, 2, 1, 11), "B": (2, 11, 10, 11), "C": (13, 11, 21, 11),
    "D": (22, 2, 22, 11), "E": (13, 2, 21, 2), "F": (2, 2, 10, 2),
    "G": (11, 2, 11, 11),
}


def _render_template(digit: int, h: int = 28, w: int = 28) -> np.ndarray:
    img = np.zeros((h, w), np.float32)
    r_off, c_off = 2, 7
    for seg in _SEGMENTS[digit]:
        r0, c0, r1, c1 = _SEG_COORDS[seg]
        npts = max(abs(r1 - r0), abs(c1 - c0)) + 1
        rs = np.linspace(r0, r1, npts).round().astype(int) + r_off
        cs = np.linspace(c0, c1, npts).round().astype(int) + c_off
        for rr, cc in zip(rs, cs):
            img[max(rr - 1, 0):rr + 2, max(cc - 1, 0):cc + 2] = 1.0
    return img


_TEMPLATES = None


def _templates() -> np.ndarray:
    global _TEMPLATES
    if _TEMPLATES is None:
        _TEMPLATES = np.stack([_render_template(d) for d in range(10)])
    return _TEMPLATES


def digits(n: int, seed: int = 0, noise: float = 0.25,
           max_shift: int = 3) -> tuple[np.ndarray, np.ndarray]:
    """Generate ``n`` synthetic digit images.

    Returns:
      (x, y): x float32 (n, 28, 28, 1) in [0, 1]; y int32 (n,) labels.
    """
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 10, size=n).astype(np.int32)
    t = _templates()[y]                                    # (n, 28, 28)
    # per-sample affine jitter (integer shifts) + intensity + noise
    sr = rng.integers(-max_shift, max_shift + 1, size=n)
    sc = rng.integers(-max_shift, max_shift + 1, size=n)
    x = np.zeros_like(t)
    for i in range(n):                                     # cheap at MNIST scale
        x[i] = np.roll(np.roll(t[i], sr[i], axis=0), sc[i], axis=1)
    x *= rng.uniform(0.6, 1.0, size=(n, 1, 1)).astype(np.float32)
    x += noise * rng.standard_normal(x.shape).astype(np.float32)
    x = np.clip(x, 0.0, 1.0)
    return x[..., None], y


def digits_split(n_train: int = 60000, n_test: int = 10000, seed: int = 0):
    """Train/test split mirroring MNIST's 60k/10k layout."""
    xtr, ytr = digits(n_train, seed=seed)
    xte, yte = digits(n_test, seed=seed + 1)
    return (xtr, ytr), (xte, yte)


# --- real MNIST idx loader (used if files are provided) ----------------------

def _read_idx(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        shape = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), np.uint8).reshape(shape)


def mnist_idx(root: str = "data/mnist"):
    """Load real MNIST from idx files if present, else return None."""
    names = {
        "xtr": ["train-images-idx3-ubyte", "train-images.idx3-ubyte"],
        "ytr": ["train-labels-idx1-ubyte", "train-labels.idx1-ubyte"],
        "xte": ["t10k-images-idx3-ubyte", "t10k-images.idx3-ubyte"],
        "yte": ["t10k-labels-idx1-ubyte", "t10k-labels.idx1-ubyte"],
    }
    out = {}
    for k, cands in names.items():
        found = None
        for c in cands:
            for suffix in ("", ".gz"):
                p = os.path.join(root, c + suffix)
                if os.path.exists(p):
                    found = p
                    break
            if found:
                break
        if not found:
            return None
        out[k] = _read_idx(found)
    xtr = (out["xtr"].astype(np.float32) / 255.0)[..., None]
    xte = (out["xte"].astype(np.float32) / 255.0)[..., None]
    return (xtr, out["ytr"].astype(np.int32)), (xte, out["yte"].astype(np.int32))


# --- synthetic LM token stream ------------------------------------------------

def lm_tokens(n_seqs: int, seq_len: int, vocab: int, seed: int = 0) -> np.ndarray:
    """Zipf-distributed token sequences with a deterministic bigram twist so
    that a real LM can measurably reduce loss below unigram entropy."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = 1.0 / ranks ** 1.1
    p /= p.sum()
    toks = rng.choice(vocab, size=(n_seqs, seq_len), p=p).astype(np.int32)
    # bigram structure: every even position partially determines the next token
    det = (toks[:, :-1:2] * 7 + 13) % vocab
    mask = rng.random(det.shape) < 0.5
    toks[:, 1::2] = np.where(mask, det, toks[:, 1::2])
    return toks
