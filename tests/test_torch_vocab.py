"""The port's vocabulary and keyframe database against the JAX package.

Every case of `tests/test_vocab.py` runs on the port (its `Vocabulary` on
the CPU), and the two packages are held equal on the same seeded
descriptors: the trained tables and the words exactly, the database
query's keyframes exactly and its scores within 1e-12, the DBoW2 file
byte for byte, and the stale inverted file of a reused keyframe slot
(ROADMAP queue 3 q), which the port mirrors.
"""

import numpy as np
import pytest

import tests.test_vocab as jax_cases
from gmmloc_tpu.vocab import bow as jbow

from gmmloc_tpu_torch.vocab import bow


class CpuVocabulary(bow.Vocabulary):
    """The port's vocabulary with its descent on the CPU."""

    def __init__(self, *args, **kw):
        if len(args) < 7:
            kw.setdefault("device", "cpu")
        super().__init__(*args, **kw)

    @classmethod
    def train(cls, descs, *args, **kw):
        return super().train(descs, *args, device="cpu", **kw)

    @classmethod
    def load(cls, path):
        return super().load(path, device="cpu")

    @classmethod
    def load_dbow2(cls, path, desc_len=32):
        return super().load_dbow2(path, desc_len, device="cpu")


CASES = [name for name in dir(jax_cases) if name.startswith("test_")]


def test_every_reference_case_is_listed():
    assert len(CASES) == 8, CASES


@pytest.mark.parametrize("case", CASES)
def test_reference_case_on_port(case, monkeypatch, tmp_path):
    """The JAX test's body with the port's classes in place of the JAX
    package's."""
    import inspect

    monkeypatch.setattr(jax_cases, "Vocabulary", CpuVocabulary)
    monkeypatch.setattr(jax_cases, "KeyFrameDatabase", bow.KeyFrameDatabase)
    fn = getattr(jax_cases, case)
    args = {"rng": np.random.default_rng(42), "tmp_path": tmp_path}
    fn(**{p: args[p] for p in inspect.signature(fn).parameters})


def _pair(seed, n=3000, k=8, depth=3):
    descs = np.random.default_rng(seed).integers(0, 256, (n, 32), dtype=np.uint8)
    return (descs, jbow.Vocabulary.train(descs, k=k, depth=depth, seed=seed),
            CpuVocabulary.train(descs, k=k, depth=depth, seed=seed))


@pytest.mark.parametrize("seed,k,depth", [(1, 8, 3), (2, 10, 3), (3, 6, 4)])
def test_trained_vocabulary_equals_reference(seed, k, depth):
    """Training reads the descent (the idf weights), so the tables agree
    only if the descent is exact, ties included."""
    descs, ref, out = _pair(seed, k=k, depth=depth)
    for name in ("children", "node_desc", "word_id", "word_weight"):
        np.testing.assert_array_equal(getattr(out, name), getattr(ref, name), err_msg=name)
    assert (out.k, out.depth, out.n_words) == (ref.k, ref.depth, ref.n_words)
    rng = np.random.default_rng(seed + 100)
    queries = np.concatenate([descs[:500], jax_cases.corrupt(descs[:300], rng),
                              rng.integers(0, 256, (700, 32), dtype=np.uint8)])
    np.testing.assert_array_equal(out.transform_words(queries), ref.transform_words(queries))


def test_descent_takes_the_first_of_tied_children():
    """Two children at the same Hamming distance: the first one wins, as
    jnp.argmin picks it."""
    children = np.array([[1, 2], [-1, -1], [-1, -1]], np.int32)
    node_desc = np.zeros((3, 32), np.uint8)
    node_desc[1, 0], node_desc[2, 0] = 0b01, 0b10     # both 1 bit from zero
    word_id = np.array([-1, 0, 1], np.int32)
    weight = np.ones(2, np.float32)
    q = np.zeros((4, 32), np.uint8)
    q[3, 0] = 0b10                                     # nearer the second
    ref = jbow.Vocabulary(children, node_desc, word_id, weight, 2, 1)
    out = CpuVocabulary(children, node_desc, word_id, weight, 2, 1)
    np.testing.assert_array_equal(out.transform_words(q), [0, 0, 0, 1])
    np.testing.assert_array_equal(out.transform_words(q), ref.transform_words(q))


def _databases(seed, n_kf=12, per=250):
    descs, jv, tv = _pair(seed, n=4000)
    scenes = [descs[i * per:(i + 1) * per] for i in range(n_kf)]
    jdb, tdb = jbow.KeyFrameDatabase(jv), bow.KeyFrameDatabase(tv)
    for kf, sc in enumerate(scenes):
        jdb.add(kf, sc)
        tdb.add(kf, sc)
    return scenes, jdb, tdb


def _same_results(a, b):
    assert [kf for kf, _ in a] == [kf for kf, _ in b]
    np.testing.assert_allclose([s for _, s in a], [s for _, s in b], rtol=0, atol=1e-12)


@pytest.mark.parametrize("seed", [4, 5])
def test_query_equals_reference(seed):
    scenes, jdb, tdb = _databases(seed)
    rng = np.random.default_rng(seed)
    for i in (0, 5, 11):
        q = jax_cases.corrupt(scenes[i], rng)
        valid = rng.random(len(q)) > 0.2
        for top in (5, 10):
            res = tdb.query(q, valid, top=top)
            assert res and res[0][0] == i
            _same_results(res, jdb.query(q, valid, top=top))


def test_reused_slot_keeps_stale_words_as_reference():
    """Queue 3 q: keyframe 3 is culled without leaving the database and
    its slot is reused by another scene. The inverted file still holds
    the old scene's words for slot 3, so a query of the old scene scores
    slot 3, in both packages alike."""
    scenes, jdb, tdb = _databases(6)
    rng = np.random.default_rng(6)
    other = rng.integers(0, 256, (250, 32), dtype=np.uint8)
    for db in (jdb, tdb):
        db.add(3, other)                   # the slot's reuse; no remove()
    q = jax_cases.corrupt(scenes[3], rng)
    res = tdb.query(q, top=10)
    _same_results(res, jdb.query(q, top=10))
    fresh = bow.KeyFrameDatabase(tdb.voc)
    for kf, sc in enumerate(scenes):
        fresh.add(kf, other if kf == 3 else sc)
    stale = dict(res)[3]
    assert stale > dict(fresh.query(q, top=12)).get(3, 0.0) + 0.1


def test_dbow2_bytes_equal_reference(tmp_path):
    _, ref, out = _pair(7, n=1500, k=6)
    pa, pb = str(tmp_path / "ref.bin"), str(tmp_path / "port.bin")
    ref.save_dbow2(pa)
    out.save_dbow2(pb)
    assert open(pa, "rb").read() == open(pb, "rb").read()
    back = CpuVocabulary.load_dbow2(pa)
    for name in ("children", "node_desc", "word_id", "word_weight"):
        np.testing.assert_array_equal(getattr(back, name),
                                      getattr(jbow.Vocabulary.load_dbow2(pa), name))


def test_vocabulary_device_defaults_to_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    descs = np.zeros((20, 32), np.uint8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bow.Vocabulary.train(descs, k=4, depth=2)
