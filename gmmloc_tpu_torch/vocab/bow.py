"""Binary bag-of-words vocabulary + keyframe database.

PyTorch port of `gmmloc_tpu/vocab/bow.py` (the DBoW2 capability surface:
TemplatedVocabulary k-ary tree, TF-IDF BowVector, L1 scoring). The
vocabulary is trained here (hierarchical binary k-medians with
majority-vote centers) on descriptors of the target domain, and it exists
for place recognition: an inverted-index keyframe database with TF-IDF
L1 scoring for relocalization and loop detection.

  - Training, the BoW vectors, scoring, save/load (npz) and the DBoW2
    binary format are host numpy, copied as they are.
  - The tree descent runs on the vocabulary's device: L fixed steps of a
    k-child Hamming argmin for all features at once. The popcount is a
    256-entry bit-count table gathered by the XOR byte and summed in
    int32; ties take the first child (as `jnp.argmin`), on the CPU and on
    the card.
  - `KeyFrameDatabase` keeps a culled keyframe's words when its slot is
    reused (`add` replaces `bow[kf]` but not the old inverted-file
    entries), as the JAX package does.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..utils.device import resolve

# bits set in each byte value
_POPCOUNT8 = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None], axis=1).sum(1)


def _majority_center(descs: np.ndarray) -> np.ndarray:
    """Majority vote per bit (FORB::meanValue equivalent)."""
    bits = np.unpackbits(descs, axis=1)           # (n, 256)
    maj = (bits.sum(0) * 2 >= len(descs)).astype(np.uint8)
    return np.packbits(maj)


def _hamming_np(a, b):
    return np.unpackbits(a[:, None, :] ^ b[None, :, :], axis=-1).sum(-1)


class Vocabulary:
    """k-ary tree of binary centers, depth L; leaves are words. The tables
    are host numpy; the descent runs on `device`."""

    def __init__(self, children: np.ndarray, node_desc: np.ndarray,
                 word_id: np.ndarray, word_weight: np.ndarray,
                 k: int, depth: int, device="cuda"):
        self.children = children        # (n_nodes, k) int32, -1 = none
        self.node_desc = node_desc      # (n_nodes, 32) uint8
        self.word_id = word_id          # (n_nodes,) int32, -1 for inner
        self.word_weight = word_weight  # (n_words,) float32 idf
        self.k = k
        self.depth = depth
        self.n_words = len(word_weight)
        self.device = resolve(device)
        dev = self.device
        self._children = torch.as_tensor(np.asarray(children, np.int64), device=dev)
        self._node_desc = torch.as_tensor(np.asarray(node_desc, np.uint8), device=dev)
        self._word_id = torch.as_tensor(np.asarray(word_id, np.int32), device=dev)
        self._popc = torch.as_tensor(_POPCOUNT8.astype(np.int32), device=dev)

    def to(self, device) -> "Vocabulary":
        """The same vocabulary with its descent on `device` (the host
        tables are shared)."""
        if resolve(device) == self.device:
            return self
        return Vocabulary(self.children, self.node_desc, self.word_id, self.word_weight,
                          self.k, self.depth, device)

    # -------------------------------------------------------------- train

    @classmethod
    def train(cls, descs: np.ndarray, k: int = 10, depth: int = 4,
              seed: int = 0, kmeans_iters: int = 8, device="cuda") -> "Vocabulary":
        """Hierarchical binary k-medians (TemplatedVocabulary::create)."""
        rng = np.random.default_rng(seed)
        children_l: List[List[int]] = [[-1] * k]  # root = node 0
        desc_l: List[np.ndarray] = [np.zeros(32, np.uint8)]
        word_rows: List[int] = []

        def cluster(node: int, subset: np.ndarray, level: int):
            if level == depth or len(subset) <= k:
                # leaf: this node is a word
                word_rows.append(node)
                return
            # k-medians with majority-vote centers
            uniq = np.unique(subset, axis=0)
            kk = min(k, len(uniq))
            centers = uniq[rng.choice(len(uniq), kk, replace=False)]
            for _ in range(kmeans_iters):
                d = _hamming_np(subset, centers)
                assign = d.argmin(1)
                new_centers = []
                for c in range(kk):
                    sel = subset[assign == c]
                    new_centers.append(
                        _majority_center(sel) if len(sel) else centers[c]
                    )
                centers = np.stack(new_centers)
            d = _hamming_np(subset, centers)
            assign = d.argmin(1)
            for c in range(kk):
                child = len(desc_l)
                children_l.append([-1] * k)
                desc_l.append(centers[c])
                children_l[node][c] = child
                sel = subset[assign == c]
                if len(sel):
                    cluster(child, sel, level + 1)
                else:
                    word_rows.append(child)

        cluster(0, np.asarray(descs, np.uint8), 0)

        n_nodes = len(desc_l)
        children = np.full((n_nodes, k), -1, np.int32)
        for i, ch in enumerate(children_l):
            children[i] = ch
        node_desc = np.stack(desc_l)
        word_id = np.full(n_nodes, -1, np.int32)
        for w, node in enumerate(word_rows):
            word_id[node] = w
        # idf weights from the training corpus (uniform doc assumption)
        weight = np.ones(len(word_rows), np.float32)
        voc = cls(children, node_desc, word_id, weight, k, depth, device)
        # set idf from training descriptor distribution
        words = voc.transform_words(descs)
        counts = np.bincount(words[words >= 0], minlength=voc.n_words) + 1
        voc.word_weight = np.log(len(descs) / counts).astype(np.float32)
        return voc

    # ---------------------------------------------------------- transform

    def descend(self, desc: torch.Tensor) -> torch.Tensor:
        """(N,32) uint8 on the vocabulary's device -> (N,) int32 word ids
        (-1 if lost): `depth` steps of a k-child Hamming argmin, staying
        at a node without children."""
        children, node_desc = self._children, self._node_desc
        node = torch.zeros(desc.shape[0], dtype=torch.int64, device=desc.device)
        for _ in range(self.depth):
            ch = children[node]                                   # (N, k)
            cd = node_desc[torch.clamp(ch, min=0)]                # (N, k, 32)
            x = torch.bitwise_xor(cd, desc[:, None, :])
            dist = self._popc[x.long()].sum(-1, dtype=torch.int32)
            dist = torch.where(ch >= 0, dist, 1 << 20)
            nxt = torch.gather(ch, 1, torch.argmin(dist, dim=1)[:, None])[:, 0]
            node = torch.where((ch >= 0).any(dim=1), nxt, node)
        return self._word_id[node]

    def transform_words(self, descs) -> np.ndarray:
        d = torch.as_tensor(np.asarray(descs, np.uint8), device=self.device)
        return self.descend(d).cpu().numpy()

    def bow_vector(self, descs, valid=None) -> np.ndarray:
        """TF-IDF L1-normalized word histogram (n_words,)."""
        words = self.transform_words(descs)
        if valid is not None:
            words = words[np.asarray(valid)]
        words = words[words >= 0]
        v = np.zeros(self.n_words, np.float32)
        np.add.at(v, words, 1.0)
        v *= self.word_weight
        s = v.sum()
        return v / s if s > 0 else v

    @staticmethod
    def score_l1(a: np.ndarray, b: np.ndarray) -> float:
        """DBoW2 L1 score in [0,1] (ScoringObject.cpp L1Scoring)."""
        return float(1.0 - 0.5 * np.abs(a - b).sum())

    # ------------------------------------------------------------ save/load

    def save(self, path: str) -> None:
        np.savez_compressed(
            path, children=self.children, node_desc=self.node_desc,
            word_id=self.word_id, word_weight=self.word_weight,
            k=self.k, depth=self.depth,
        )

    @classmethod
    def load(cls, path: str, device="cuda") -> "Vocabulary":
        z = np.load(path)
        return cls(
            z["children"], z["node_desc"], z["word_id"], z["word_weight"],
            int(z["k"]), int(z["depth"]), device,
        )

    # ------------------------------------------------- DBoW2 binary format

    @classmethod
    def load_dbow2(cls, path: str, desc_len: int = 32, device="cuda") -> "Vocabulary":
        """Parse a DBoW2 packed binary vocabulary (ORBvoc.bin).

        Wire format (orb_dbow2 TemplatedVocabulary.h
        loadFromBinaryFile/saveToBinaryFile): 24-byte header of six
        4-byte little-endian ints (nb_nodes, size_node, k, L, scoring,
        weighting), then one record per non-root node in node-id order:
        int32 parent, desc_len descriptor bytes, float32 weight, one
        is_leaf byte (size_node = desc_len + 9). Children order is the
        file order of their records (the reference's push_back); leaf
        word ids are assigned in node-id order."""
        raw = open(path, "rb").read()
        hdr = np.frombuffer(raw[:24], "<u4")
        nb_nodes, size_node, k, L = int(hdr[0]), int(hdr[1]), int(hdr[2]), int(hdr[3])
        if size_node != desc_len + 9:
            raise ValueError(
                f"size_node {size_node} != desc_len+9 ({desc_len + 9})"
            )
        body = raw[24:]
        n_rec = len(body) // size_node
        # the reference writes nodes 1..nb_nodes-1 and reads until EOF
        n_rec = min(n_rec, max(nb_nodes - 1, 0))
        rec = np.frombuffer(
            body[: n_rec * size_node], np.uint8
        ).reshape(n_rec, size_node)
        parent = rec[:, :4].copy().view("<i4")[:, 0]
        desc = rec[:, 4 : 4 + desc_len]
        weight = rec[:, 4 + desc_len : 8 + desc_len].copy().view("<f4")[:, 0]
        is_leaf = rec[:, 8 + desc_len] != 0

        n_nodes = n_rec + 1
        children = np.full((n_nodes, k), -1, np.int32)
        n_child = np.zeros(n_nodes, np.int32)
        node_desc = np.zeros((n_nodes, desc_len), np.uint8)
        node_desc[1:] = desc
        word_id = np.full(n_nodes, -1, np.int32)
        w = 0
        for i in range(n_rec):
            nid = i + 1
            p = int(parent[i])
            children[p, n_child[p]] = nid
            n_child[p] += 1
            if is_leaf[i]:
                word_id[nid] = w
                w += 1
        word_weight = weight[is_leaf].astype(np.float32)
        return cls(children, node_desc, word_id, word_weight, k, L, device)

    def save_dbow2(self, path: str) -> None:
        """Write the DBoW2 packed binary format (round-trip counterpart
        of load_dbow2; same record layout as saveToBinaryFile)."""
        n_nodes = len(self.node_desc)
        desc_len = self.node_desc.shape[1]
        # reconstruct per-node parent pointers from the children table
        parent = np.zeros(n_nodes, np.int32)
        for p in range(n_nodes):
            for c in self.children[p]:
                if c >= 0:
                    parent[c] = p
        with open(path, "wb") as f:
            f.write(
                np.array(
                    [n_nodes, desc_len + 9, self.k, self.depth, 0, 0], "<u4"
                ).tobytes()
            )
            for nid in range(1, n_nodes):
                f.write(np.int32(parent[nid]).tobytes())
                f.write(self.node_desc[nid].tobytes())
                wgt = (
                    self.word_weight[self.word_id[nid]]
                    if self.word_id[nid] >= 0
                    else 0.0
                )
                f.write(np.float32(wgt).tobytes())
                f.write(bytes([1 if self.word_id[nid] >= 0 else 0]))


class KeyFrameDatabase:
    """Inverted-index place-recognition database (relocalization, loop
    detection). The reference has no relocalization: a failed track ends
    the run (gmmloc.cpp:157-159)."""

    def __init__(self, voc: Vocabulary):
        self.voc = voc
        # inverted file: word -> {kf: tf-idf value}. BoW vectors are
        # L1-normalized and sparse (<= n_features nonzero words), so a
        # query touches only its own words' posting lists (DBoW2
        # TemplatedDatabase::query inverted-file semantics).
        self.inv: List[dict] = [{} for _ in range(voc.n_words)]
        self.bow: dict = {}  # kf -> (word_ids int32, values float32)

    def add(self, kf: int, descs, valid=None) -> None:
        v = self.voc.bow_vector(descs, valid)
        words = np.where(v > 0)[0].astype(np.int32)
        vals = v[words]
        self.bow[kf] = (words, vals)
        for w, x in zip(words, vals):
            self.inv[w][kf] = float(x)

    def remove(self, kf: int) -> None:
        ent = self.bow.pop(kf, None)
        if ent is None:
            return
        for w in ent[0]:
            self.inv[w].pop(kf, None)

    def query(self, descs, valid=None, top: int = 5) -> List[Tuple[int, float]]:
        """Candidate KFs by shared words via the inverted file, scored
        TF-IDF L1 (DBoW2 ScoringObject.cpp L1Scoring).

        With a,b L1-normalized:  |a-b|_1 = 2 + sum_shared(|a_w-b_w| -
        a_w - b_w), so  score = 1 - 0.5|a-b|_1 = -0.5*sum_shared(...)
        -- computable from the shared words alone. Cost is
        O(sum_{query words} |posting list|), not O(n_kf * n_words).
        No share-count prefilter; every KF sharing >=1 word is scored."""
        if not self.bow:
            return []
        v = self.voc.bow_vector(descs, valid)
        acc: dict = {}
        for w in np.where(v > 0)[0]:
            a_w = float(v[w])
            for kf, b_w in self.inv[w].items():
                acc[kf] = acc.get(kf, 0.0) + abs(a_w - b_w) - a_w - b_w
        if not acc:
            return []
        kfs = np.fromiter(acc.keys(), np.int64, len(acc))
        scores = -0.5 * np.fromiter(acc.values(), np.float64, len(acc))
        order = np.argsort(-scores)[:top]
        return [(int(kfs[i]), float(scores[i])) for i in order if scores[i] > 0.0]
