"""Port parity: the classification metrics (``train/metrics.py``: AUROC,
PRC-AUC and their mean, in numpy) against the JAX package's
``classification_metrics``, which runs scikit-learn's ``roc_auc_score`` and
``precision_recall_curve`` + ``auc``. Inputs are made with numpy from a
seed: random, tied, imbalanced and single-class. Tolerance: 1e-12 absolute
(the same sums in another order).

A single-class split: scikit-learn before 1.7 raised in ``roc_auc_score``
and the JAX package's ``evaluate`` then reports auroc = prc = 0.5; later
versions warn and return NaN, so the JAX package here reports NaN. The port
keeps the documented fallback: its AUROC raises ``ValueError`` and its
``evaluate`` reports 0.5 (``tests/test_torch_classification.py``); its PRC
equals scikit-learn's on such a split."""

import warnings

import numpy as np
import pytest

from conan_fgw_tpu.train import metrics as jmetrics
from conan_fgw_tpu_torch.train import metrics as tmetrics

ATOL = 1e-12


def _case(kind: str, seed: int):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(8, 200))
    if kind == "random":
        y = (rng.random(n) < 0.5).astype(np.float32)
        pred = rng.standard_normal(n).astype(np.float32)
    elif kind == "tied":  # scores on a coarse grid: many ties, across classes too
        y = (rng.random(n) < 0.4).astype(np.float32)
        pred = np.round(rng.standard_normal(n), 1).astype(np.float32)
    elif kind == "imbalanced":  # about 1:20, as a rare-positive split
        y = (rng.random(n) < 0.05).astype(np.float32)
        y[int(rng.integers(n))] = 1.0
        y[int(rng.integers(n))] = 0.0 if y.sum() > 1 else y[0]
        pred = (rng.standard_normal(n) + 2.0 * y).astype(np.float32)
    elif kind == "probabilities":  # sigmoid outputs, as predict writes them
        y = (rng.random(n) < 0.25).astype(np.float32)
        pred = 1.0 / (1.0 + np.exp(-rng.standard_normal(n) * 3.0))
    else:
        raise ValueError(kind)
    if y.min() == y.max():
        y[0] = 1.0 - y[0]
    return pred, y


@pytest.mark.parametrize("trade_off", [False, True])
@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("kind", ["random", "tied", "imbalanced", "probabilities"])
def test_classification_metrics_match_sklearn(kind, seed, trade_off):
    pred, y = _case(kind, seed)
    want = jmetrics.classification_metrics(pred, y, trade_off)
    got = tmetrics.classification_metrics(pred, y, trade_off)
    assert got.keys() == want.keys()
    for key in want:
        assert abs(got[key] - want[key]) <= ATOL, (key, got[key], want[key])


def test_all_scores_tied():
    y = np.array([0, 1, 0, 1, 1], np.float32)
    pred = np.zeros(5, np.float32)
    want = jmetrics.classification_metrics(pred, y, True)
    got = tmetrics.classification_metrics(pred, y, True)
    for key in want:
        assert abs(got[key] - want[key]) <= ATOL, key
    assert got["auroc"] == 0.5


@pytest.mark.parametrize("label", [0.0, 1.0])
def test_single_class(label):
    pred = np.linspace(-1, 1, 7).astype(np.float32)
    y = np.full(7, label, np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            want = jmetrics.classification_metrics(pred, y)
        except ValueError:  # scikit-learn before 1.7
            want = None
    if want is not None:
        assert np.isnan(want["auroc"])
        assert abs(tmetrics.prc_auc(y.astype(np.int64), pred) - want["prc"]) <= ATOL
    with pytest.raises(ValueError, match="one class"):
        tmetrics.classification_metrics(pred, y)


def test_perfect_and_inverted_rankings():
    y = np.array([0, 0, 1, 1], np.float32)
    pred = np.array([0.1, 0.2, 0.8, 0.9], np.float32)
    assert tmetrics.roc_auc(y, pred) == 1.0 and tmetrics.prc_auc(y, pred) == 1.0
    assert tmetrics.roc_auc(y, -pred) == 0.0
