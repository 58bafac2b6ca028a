"""``TrainSettings.shuffle`` and ``TrainSettings.bucketed`` against the JAX
package on the CPU: the loader's shuffled batches, ``loop.batch_iterator``
under the per-epoch ``np.random.default_rng([seed, epoch])``, ``fit``'s
train batches over three epochs, evaluation and predict without buckets.
Batches are compared byte for byte (the same molecules in the same rows).
Small sizes: B <= 4, N <= 64, K = 2, SMALL model widths."""

import numpy as np
import pytest
import torch

from conan_fgw_tpu.data import loader as jloader
from conan_fgw_tpu.train import loop as jloop
from conan_fgw_tpu_torch.data import loader as tloader
from conan_fgw_tpu_torch.models.heads import ConanModel
from conan_fgw_tpu_torch.train import graphs as tgraphs
from conan_fgw_tpu_torch.train import loop as tloop
from conan_fgw_tpu_torch.train import predict as tpredict
from test_torch_loader import SMALL, as_jax, assert_same_batches, records

EPOCHS = 3


@pytest.fixture(autouse=True, scope="module")
def one_cpu_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_settings_defaults_are_the_jax_packages():
    t, j = tloop.TrainSettings(), jloop.TrainSettings()
    assert (t.shuffle, t.bucketed) == (j.shuffle, j.bucketed) == (False, True)


@pytest.mark.parametrize("seed", [0, 9])
def test_shuffled_batches_match_jax(seed):
    recs = records(seed=21, n=11)
    got = tloader.batches(recs, 3, 64, shuffle=True, rng=np.random.default_rng(seed))
    want = jloader.batches(as_jax(recs), 3, 64, shuffle=True, rng=np.random.default_rng(seed))
    assert_same_batches(got, want)


@pytest.mark.parametrize("seed", [0, 9])
def test_shuffled_bucketed_batches_match_jax(seed):
    """Bucket order, then each bucket's molecules, drawn in the JAX order."""
    recs = records(seed=22, n=13)
    got = tloader.bucketed_batches(recs, 3, (32, 64), shuffle=True,
                                   rng=np.random.default_rng(seed))
    want = jloader.bucketed_batches(as_jax(recs), 3, buckets=(32, 64), shuffle=True,
                                    rng=np.random.default_rng(seed))
    assert_same_batches(got, want)


@pytest.mark.parametrize("bucketed", [False, True])
@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("prefetch", [False, True])
def test_batch_iterator_epochs_match_jax(bucketed, shuffle, prefetch):
    """Three epochs of ``batch_iterator`` under each epoch's generator, as
    the JAX loop draws it, equal the JAX package's batches."""
    recs = records(seed=23, n=10)
    settings = tloop.TrainSettings(seed=7, shuffle=shuffle, bucketed=bucketed)
    for epoch in range(EPOCHS):
        rng = tloop.epoch_rng(settings, epoch)
        assert (rng is None) == (not shuffle)
        got = tloop.batch_iterator(recs, 4, 64, shuffle=shuffle, rng=rng, prefetch=prefetch,
                                   bucketed=bucketed)
        want = jloop.batch_iterator(as_jax(recs), 4, 64, shuffle=shuffle,
                                    rng=np.random.default_rng([7, epoch]), prefetch=False,
                                    bucketed=bucketed)
        assert_same_batches(got, want)


@pytest.mark.parametrize("bucketed", [False, True])
@pytest.mark.parametrize("shuffle", [False, True])
def test_fit_steps_in_the_jax_loops_order(shuffle, bucketed, monkeypatch):
    """``fit``'s train batches over three epochs are the JAX loop's, epoch by
    epoch (``np.random.default_rng([seed, epoch])``); without buckets every
    batch is padded to ``max_atoms``, one graph shape."""
    recs, val = records(seed=24, n=10), records(seed=25, n=3)
    settings = tloop.TrainSettings(batch_size=3, num_epochs=EPOCHS, seed=4, shuffle=shuffle,
                                   bucketed=bucketed)
    seen = []
    original = tgraphs.StepGraphs.train
    monkeypatch.setattr(tgraphs.StepGraphs, "train",
                        lambda self, pb: (seen.append((pb.z.shape, pb.y.copy())),
                                          original(self, pb))[1])
    result = tloop.fit(settings, recs, val, model=ConanModel(device="cpu", **SMALL),
                       device="cpu")
    max_atoms = tloop.dataset_max_atoms(recs + val)
    want = [pb for epoch in range(EPOCHS) for pb in jloop.batch_iterator(
        as_jax(recs), 3, max_atoms, shuffle=shuffle, rng=np.random.default_rng([4, epoch]),
        prefetch=False, bucketed=bucketed)]
    assert len(seen) == len(want)
    for (shape, y), pb in zip(seen, want):
        assert shape == pb.z.shape
        np.testing.assert_array_equal(y, pb.y)
    shapes = {shape[-1] for shape, _ in seen}
    assert shapes == ({max_atoms} if not bucketed else {32, 64})
    steps = {k for row in result.history for k in row if k.startswith("steps_n")}
    assert steps == {f"steps_n{n}" for n in shapes}
    if shuffle:  # the epochs differ in order
        assert not all(np.array_equal(a, b) for (_, a), (_, b) in zip(seen[:4], seen[4:8]))


def test_unbucketed_evaluation_and_predict_keep_the_input_order():
    """Without buckets evaluation runs the records in input order, every
    batch at ``max_atoms``, and predict's records follow that order: its
    predictions equal the bucketed run's, reordered."""
    recs = records(seed=26, n=9)
    model = ConanModel(device="cpu", seed=1, **SMALL)
    runs = {}
    for bucketed in (True, False):
        settings = tloop.TrainSettings(batch_size=4, bucketed=bucketed)
        ordered, pred, y = tpredict.predict_records(model, recs, settings, 64, device="cpu")
        runs[bucketed] = {r.mol_id: float(p) for r, p in zip(ordered, pred)}
        np.testing.assert_array_equal(y, np.asarray([r.y for r in ordered], np.float32))
    assert [r.mol_id for r in recs] == list(runs[False])
    assert runs[True].keys() == runs[False].keys()
    for k, v in runs[False].items():
        assert abs(v - runs[True][k]) <= 1e-5 * max(1.0, abs(v)), k
