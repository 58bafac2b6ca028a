"""The port's ``data/splitters.py`` against the JAX package on
``data/sol250``'s SMILES: ``generate_scaffold`` (RDKit's Murcko scaffold
where RDKit is installed, else the built-in framework hash) gives the same
strings, and ``ScaffoldSplitter`` and ``RandomSplitter`` the same index
splits."""

from pathlib import Path

import numpy as np
import pytest

from conan_fgw_tpu.data import splitters as jsplit
from conan_fgw_tpu_torch.data import splitters as tsplit
from conan_fgw_tpu_torch.data.datasets import read_csv_rows

SOL250 = Path(__file__).resolve().parents[1] / "data" / "sol250"


@pytest.fixture(scope="module")
def smiles():
    return [r["smiles"] for mode in ("train", "valid", "test")
            for r in read_csv_rows(str(SOL250 / f"{mode}.csv"), "logS_surrogate")]


def test_both_packages_take_the_same_scaffold_route():
    assert tsplit.HAVE_RDKIT == jsplit.HAVE_RDKIT


@pytest.mark.parametrize("chirality", [False, True])
def test_generate_scaffold_matches_jax(smiles, chirality):
    got = [tsplit.generate_scaffold(s, include_chirality=chirality) for s in smiles]
    assert got == [jsplit.generate_scaffold(s, include_chirality=chirality) for s in smiles]
    # rings give scaffolds of their own, acyclic molecules share the empty one
    assert len(set(got)) > 10 and "" in got


@pytest.mark.parametrize("fracs", [(0.8, 0.1, 0.1), (0.6, 0.2, 0.2)])
def test_scaffold_splitter_matches_jax(smiles, fracs):
    got = tsplit.ScaffoldSplitter().split(smiles, *fracs)
    assert got == jsplit.ScaffoldSplitter().split(smiles, *fracs)
    assert sorted(i for part in got for i in part) == list(range(len(smiles)))


@pytest.mark.parametrize("seed", [0, 42])
def test_random_splitter_matches_jax(smiles, seed):
    got = tsplit.RandomSplitter().split(smiles, 0.8, 0.1, 0.1, seed=seed)
    want = jsplit.RandomSplitter().split(smiles, 0.8, 0.1, 0.1, seed=seed)
    assert [np.asarray(p).tolist() for p in got] == [np.asarray(p).tolist() for p in want]
    assert [len(p) for p in got] == [int(0.8 * len(smiles)), int(0.9 * len(smiles))
                                     - int(0.8 * len(smiles)),
                                     len(smiles) - int(0.9 * len(smiles))]
