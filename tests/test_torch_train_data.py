"""The port's LM data (``repro_torch.data.synthetic``: ``BigramLM``,
``make_bigram_lm``, ``sample_bigram``, ``lm_batch``) and elastic scaling
(``repro_torch.runtime.elastic``) against the reference's.

Reference twins: the bigram cases of ``tests/test_data_configs.py`` and
the elastic cases of ``test_checkpoint.py``. The port draws with a
``torch.Generator`` and does not reproduce ``jax.random``'s bits, so the
bigram cases hold the properties (shapes, the shift between tokens and
labels, a conditional entropy far below the uniform one, determinism per
seed) and feed the reference's realized ``trans``. ``resize_ef`` and
``rebalance_weights`` run eagerly in the reference, and equal it bit for
bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.synthetic import make_bigram_lm as ref_make_bigram_lm
from repro.runtime import elastic as ref_elastic
from repro_torch.data import BigramLM, lm_batch, make_bigram_lm, sample_bigram
from repro_torch.runtime import elastic

torch.set_num_threads(1)


def _cond_entropy(toks: np.ndarray, v: int) -> float:
    joint = np.zeros((v, v))
    for row in toks:
        np.add.at(joint, (row[:-1], row[1:]), 1)
    cond = joint / np.maximum(joint.sum(1, keepdims=True), 1)
    ent = -np.nansum(np.where(cond > 0, cond * np.log(np.where(
        cond > 0, cond, 1)), 0), axis=1)
    return float(np.nanmean(ent))


def test_bigram_has_learnable_structure():
    lm = make_bigram_lm(0, 64, device="cpu")
    assert lm.trans.shape == (64, 64) and lm.trans.dtype == torch.float32
    toks = sample_bigram(lm, torch.Generator().manual_seed(1), 64, 128)
    assert toks.shape == (64, 129) and toks.dtype == torch.int64
    assert _cond_entropy(toks.numpy(), 64) < 0.7 * np.log(64)
    again = sample_bigram(make_bigram_lm(torch.Generator().manual_seed(0),
                                         64, device="cpu"),
                          torch.Generator().manual_seed(1), 64, 128)
    assert torch.equal(toks, again)


def test_bigram_on_the_reference_table():
    trans = np.asarray(ref_make_bigram_lm(jax.random.PRNGKey(0), 64).trans)
    lm = BigramLM(trans=torch.as_tensor(trans))
    toks = sample_bigram(lm, torch.Generator().manual_seed(2), 64, 128)
    assert _cond_entropy(toks.numpy(), 64) < 0.7 * np.log(64)
    # the transitions follow the table's rows: the most frequent successor
    # of a token is among its table row's top 8
    t = toks.numpy()
    hits = [np.argmax(np.bincount(t[:, 1:][t[:, :-1] == a], minlength=64))
            in np.argsort(-trans[a])[:8] for a in range(64)
            if np.sum(t[:, :-1] == a) >= 20]
    assert np.mean(hits) > 0.9, np.mean(hits)


def test_lm_batch_shapes():
    lm = make_bigram_lm(0, 32, device="cpu")
    b = lm_batch(lm, torch.Generator().manual_seed(1), 4, 16)
    assert b["tokens"].shape == (4, 16) and b["labels"].shape == (4, 16)
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])


@pytest.mark.parametrize("new_k,redistribute", [(2, True), (2, False),
                                                (3, True), (4, True),
                                                (6, True)])
def test_resize_ef_equals_the_reference(new_k, redistribute):
    ef = np.random.default_rng(0).standard_normal((4, 37)).astype(np.float32)
    want = np.asarray(ref_elastic.resize_ef(jnp.asarray(ef), new_k,
                                            redistribute=redistribute))
    got = elastic.resize_ef(torch.as_tensor(ef), new_k,
                            redistribute=redistribute).numpy()
    assert np.array_equal(want.view(np.int32), got.view(np.int32))
    if redistribute:
        np.testing.assert_allclose(got.sum(), ef.sum(), rtol=1e-5)


@pytest.mark.parametrize("n,counts", [(4, None), (3, None), (7, None),
                                      (2, [30, 10]), (3, [5, 7, 11])])
def test_rebalance_weights_equals_the_reference(n, counts):
    want = np.asarray(ref_elastic.rebalance_weights(n, counts))
    got = elastic.rebalance_weights(n, counts).numpy()
    assert np.array_equal(want.view(np.int32), got.view(np.int32))
