"""Binary bag of words and the keyframe database, plain numpy.

Frozen copy of the port's `vocab/bow.py` as the relocalization runs it
(DBoW2's k-ary tree of binary centres, TF-IDF BoW vectors, L1 scores):

  - `train`: hierarchical binary k-medians with majority-vote centres,
    the idf weights from the training descriptors (the port's
    `Vocabulary.train`, host numpy there too);
  - `descend`: the tree descent, `depth` steps of a k-child Hamming
    argmin, staying at a node without children; ties take the first
    child (`ties="last"`: the last one, the control);
  - `bow_vector`: the word histogram of the valid features times the idf
    weights, L1-normalised, in float64 (`dtype`: the control's float16);
  - `Database`: the inverted file as the port keeps it (`add` replaces a
    keyframe's vector but leaves its slot's old words in the inverted
    file), and `query`, the L1 score of every keyframe that shares a word
    with the query, from the shared words alone, the best `top` with a
    positive score.
"""

from __future__ import annotations

import numpy as np

POPCOUNT8 = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None], axis=1).sum(1)


def hamming(a, b):
    """(N,32) x (M,32) uint8 -> (N,M) int64 bit distances."""
    return POPCOUNT8[a[:, None, :] ^ b[None, :, :]].sum(-1, dtype=np.int64)


def _majority(descs):
    bits = np.unpackbits(descs, axis=1)
    return np.packbits((bits.sum(0) * 2 >= len(descs)).astype(np.uint8))


class Vocabulary:
    def __init__(self, children, node_desc, word_id, k: int, depth: int):
        self.children, self.node_desc, self.word_id = children, node_desc, word_id
        self.k, self.depth = k, depth
        self.n_words = int((word_id >= 0).sum())
        self.weight = np.ones(self.n_words)

    def descend(self, desc, ties: str = "first"):
        """(N,32) uint8 -> (N,) word ids (-1: no word)."""
        desc = np.asarray(desc, np.uint8)
        node = np.zeros(len(desc), np.int64)
        rows = np.arange(len(desc))
        for _ in range(self.depth):
            ch = self.children[node]
            dist = np.where(ch >= 0, POPCOUNT8[self.node_desc[np.maximum(ch, 0)]
                                               ^ desc[:, None, :]].sum(-1), 1 << 20)
            pick = (np.argmin(dist, 1) if ties == "first"
                    else self.k - 1 - np.argmin(dist[:, ::-1], 1))
            node = np.where((ch >= 0).any(1), ch[rows, pick], node)
        return self.word_id[node]

    def bow_vector(self, words, valid, dtype=np.float64):
        """{word: value} of the valid features' words."""
        w = np.asarray(words)[np.asarray(valid, bool)]
        w = w[w >= 0]
        v = np.bincount(w, minlength=self.n_words).astype(dtype) * self.weight.astype(dtype)
        s = v.sum(dtype=dtype)
        if s > 0:
            v = (v / s).astype(dtype)
        nz = np.nonzero(v)[0]
        return dict(zip(nz.tolist(), v[nz]))


def train(descs, k: int, depth: int, seed: int, kmeans_iters: int = 8) -> Vocabulary:
    """The tree of `descs` (TemplatedVocabulary::create), its draws from
    `seed` in the port's order."""
    rng = np.random.default_rng(seed)
    children = [[-1] * k]
    node_desc = [np.zeros(32, np.uint8)]
    words = []

    def cluster(node, subset, level):
        if level == depth or len(subset) <= k:
            words.append(node)
            return
        uniq = np.unique(subset, axis=0)
        kk = min(k, len(uniq))
        centres = uniq[rng.choice(len(uniq), kk, replace=False)]
        for _ in range(kmeans_iters):
            assign = hamming(subset, centres).argmin(1)
            centres = np.stack([_majority(subset[assign == c]) if (assign == c).any()
                                else centres[c] for c in range(kk)])
        assign = hamming(subset, centres).argmin(1)
        for c in range(kk):
            child = len(node_desc)
            children.append([-1] * k)
            node_desc.append(centres[c])
            children[node][c] = child
            sel = subset[assign == c]
            if len(sel):
                cluster(child, sel, level + 1)
            else:
                words.append(child)

    descs = np.asarray(descs, np.uint8)
    cluster(0, descs, 0)
    word_id = np.full(len(node_desc), -1, np.int64)
    word_id[words] = np.arange(len(words))
    voc = Vocabulary(np.array(children, np.int64), np.stack(node_desc), word_id, k, depth)
    w = voc.descend(descs)
    counts = np.bincount(w[w >= 0], minlength=voc.n_words) + 1
    voc.weight = np.log(len(descs) / counts).astype(np.float32).astype(np.float64)
    return voc


class Database:
    """The inverted file: word -> {keyframe: value}, and each keyframe's
    current vector."""

    def __init__(self, inv=None, bow=None):
        self.inv = inv if inv is not None else {}
        self.bow = bow if bow is not None else {}

    def add(self, kf: int, vec: dict) -> None:
        self.bow[kf] = vec
        for w, x in vec.items():
            self.inv.setdefault(w, {})[kf] = x

    def query(self, vec: dict, top: int, dtype=np.float64) -> list:
        """[(keyframe, score)], best first: 1 - |a - b|_1 / 2 of
        L1-normalised vectors, which is -1/2 the sum over shared words of
        |a_w - b_w| - a_w - b_w."""
        acc = {}
        for w, a in vec.items():
            a = dtype(a)
            for kf, b in self.inv.get(w, {}).items():
                b = dtype(b)
                acc[kf] = dtype(acc.get(kf, dtype(0)) + (abs(a - b) - a - b))
        if not acc:
            return []
        kfs = np.array(list(acc), np.int64)
        scores = np.array([float(dtype(-0.5) * x) for x in acc.values()])
        order = np.argsort(-scores, kind="stable")[:top]
        return [(int(kfs[i]), float(scores[i])) for i in order if scores[i] > 0.0]
