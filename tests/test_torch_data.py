"""Port parity: the synthetic data pipeline.  ``repro_torch.data.pipeline``
is a copy of the JAX package's pure-numpy module; both must draw the same
token batches from the same seed and step."""
import itertools

import numpy as np
import pytest

from repro.data import pipeline as JP
from repro_torch.data import pipeline as TP


@pytest.mark.parametrize("vocab,seed,batch,seq", [(256, 0, 4, 32),
                                                   (1000, 7, 2, 64),
                                                   (151936, 3, 2, 16)])
def test_synthetic_lm_batches_equal_jax(vocab, seed, batch, seq):
    j, t = JP.SyntheticLM(vocab, seed), TP.SyntheticLM(vocab, seed)
    for step in (0, 1, 1000):
        jb, tb = j.lm_batch(step, batch, seq), t.lm_batch(step, batch, seq)
        for key in ("tokens", "labels"):
            assert tb[key].dtype == jb[key].dtype == np.int32
            np.testing.assert_array_equal(tb[key], jb[key])


def test_batch_iterators_equal_jax():
    j = JP.make_batch_iterator(256, 2, 16, seed=5, start_step=3)
    t = TP.make_batch_iterator(256, 2, 16, seed=5, start_step=3)
    for jb, tb in itertools.islice(zip(j, t), 3):
        np.testing.assert_array_equal(tb["tokens"], jb["tokens"])


def test_calib_stream_equals_jax():
    j = list(JP.calib_stream(256, 20, 32, seed=1234, batch=5))
    t = list(TP.calib_stream(256, 20, 32, seed=1234, batch=5))
    assert len(t) == len(j) == 4
    for jb, tb in zip(j, t):
        np.testing.assert_array_equal(tb["labels"], jb["labels"])
