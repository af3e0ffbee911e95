"""Matmul Hamming matcher vs a numpy popcount oracle (reference: BFMatcher)."""

import numpy as np

import jax.numpy as jnp

from online_3d_reconstruction.features.match import hamming_matrix, match_descriptors


def _np_hamming(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(Ka, Kb) popcount Hamming over packed uint32 words."""
    x = a[:, None, :] ^ b[None, :, :]
    return np.vectorize(lambda v: bin(v).count("1"))(x).sum(axis=-1)


def _rand_desc(rng, k, words=8):
    return rng.integers(0, 2**32, size=(k, words), dtype=np.uint32)


class TestHammingMatrix:
    def test_matches_numpy_popcount(self):
        rng = np.random.default_rng(0)
        a = _rand_desc(rng, 16)
        b = _rand_desc(rng, 24)
        ours = np.asarray(
            hamming_matrix(jnp.asarray(a), jnp.asarray(b),
                           jnp.ones(16, bool), jnp.ones(24, bool))
        )
        ref = _np_hamming(a, b)
        np.testing.assert_array_equal(ours, ref.astype(np.float32))

    def test_invalid_rows_inf(self):
        rng = np.random.default_rng(1)
        a = _rand_desc(rng, 4)
        valid_a = jnp.array([True, False, True, True])
        d = np.asarray(hamming_matrix(jnp.asarray(a), jnp.asarray(a),
                                      valid_a, jnp.ones(4, bool)))
        assert (d[1] > 1e8).all()


class TestMatcher:
    def test_self_match_identity(self):
        rng = np.random.default_rng(2)
        desc = _rand_desc(rng, 32)
        m = match_descriptors(jnp.asarray(desc), jnp.asarray(desc),
                              jnp.ones(32, bool), jnp.ones(32, bool),
                              max_hamming=256, ratio=1.0, cross_check=True)
        assert np.array_equal(np.asarray(m.index), np.arange(32))
        assert np.all(np.asarray(m.distance) == 0)
        assert np.asarray(m.valid).all()

    def test_ratio_rejects_duplicate_train(self):
        """Two identical train descriptors make the match ambiguous."""
        rng = np.random.default_rng(3)
        desc = _rand_desc(rng, 8)
        train = np.concatenate([desc, desc[:1]], axis=0)  # duplicate of row 0
        m = match_descriptors(jnp.asarray(desc), jnp.asarray(train),
                              jnp.ones(8, bool), jnp.ones(9, bool),
                              max_hamming=256, ratio=0.9, cross_check=False)
        v = np.asarray(m.valid)
        assert not v[0]       # ambiguous: two zero-distance candidates
        assert v[1:].all()    # unique matches survive

    def test_max_hamming_gate(self):
        rng = np.random.default_rng(4)
        a = _rand_desc(rng, 8)
        b = _rand_desc(rng, 8)  # unrelated: expected Hamming ~128
        m = match_descriptors(jnp.asarray(a), jnp.asarray(b),
                              jnp.ones(8, bool), jnp.ones(8, bool),
                              max_hamming=32, ratio=1.0, cross_check=False)
        assert not np.asarray(m.valid).any()
