"""The operation and byte counts against hand counts at tiny sizes."""

import math

import numpy as np
import pytest
import torch

from conftest import ROOT

from perfbench import core, traffic
from perfbench.counts import conan_schnet as counts
from perfbench.peaks import PEAK_BYTES, PEAK_F32, PEAK_TF32

CFG = core.config(core.benchmark(ROOT), "schnet_esol", ROOT)  # F=128, 50 Gaussians, 3 blocks


def least(nbytes, flops, tc):
    return max(nbytes / PEAK_BYTES, tc / PEAK_TF32 + (flops - tc) / PEAK_F32)


def test_cfconv_least_time_by_hand():
    # one molecule of 4 atoms, two conformers with 10 and 12 capped edges
    batch = [(4, 3, np.array([10, 12]))]
    rows, E, F, G = 8, 22, 128, 50
    w = 4 * (G * F + F * F + 2 * F)
    fwd = least(4 * 4 * rows + 4 * 2 * rows * F + w, E * 2 * (G * F + F * F) + 2 * E * F,
                E * 2 * (G * F + F * F))
    bwd = least(4 * 4 * rows + 4 * 3 * rows * F + 2 * w, E * (4 * G * F + 6 * F * F) + 4 * E * F,
                E * (4 * G * F + 6 * F * F))
    assert counts.cfconv_least_s(batch, CFG) == pytest.approx(3 * (fwd + bwd), rel=1e-12)


def test_fgw_least_time_by_hand():
    # two molecules of 4 and 0 atoms (a padding row), K=2: only n=4 counts
    batch = [(4, 3, np.array([5, 5])), (0, 0, np.array([0, 0]))]
    S, n = 2, 4
    products = S * 5 * 4 * n ** 3
    flops = S * 5 * (4 * n ** 3 + 15 * n * n) + S * 25 * 10 * n * n
    nbytes = 4 * (5 * S * n * n + 2 * S * n) + 8 * S + 8 * S
    assert counts.fgw_least_s(batch, CFG) == pytest.approx(5 * least(nbytes, flops, products),
                                                          rel=1e-12)


def test_step_flops_by_hand():
    # one molecule of 2 atoms and one bond, one conformer with 2 edges
    n, bonds, E, K = 2, 1, 2, 1
    H, F, G, L, C = 128, 128, 50, 3, 64
    dense = L * 2 * K * n * (H * F + F * H + H * H) + 2 * 2 * K * n * (H * C + C * C)
    l1, l2, msg = L * 2 * E * G * F, L * 2 * E * F * F, L * 3 * E * F
    elem = L * (4 * E * G + 4 * E * F + 4 * K * n * H)
    e2 = 2 * bonds + n
    gat = 2 * (2 * n * 9 * C) + 3 * (2 * n * C * C) + 3 * 2 * (6 * e2 * C + 6 * e2 + 2 * e2 * C)
    solve = 5 * (4 * n ** 3 + 15 * n * n + 5 * 10 * n * n)
    bary = 5 * K * (solve + 4 * n * n * C + 4 * n ** 3) + 6 * K * n * n * C
    want = 3 * (dense + l2 + msg) + 2 * l1 + 2 * elem + gat + bary + 3 * 3 * 2 * C * C
    assert counts.step_flops([(n, bonds, np.array([E]))], CFG) == pytest.approx(want, rel=1e-12)


def mol(pos):
    pos = np.asarray(pos, np.float32)[None]
    n = pos.shape[1]
    return traffic.Molecule(np.full(n, 6, np.int32), pos, np.zeros((n, 9), np.int32),
                            np.zeros((0, 2), np.int32), np.zeros((0, 3), np.float32), 0.0)


def test_edges_by_hand():
    # atoms at x = 0, 5 and 11: the pairs 0-1 (5 A) and 1-2 (6 A) are within
    # the 10 A cutoff, 0-2 (11 A) is not; each pair is two directed edges
    line = mol([[0, 0, 0], [5, 0, 0], [11, 0, 0]])
    # 40 atoms in a 2 A cube: each target keeps the first 33 candidates by
    # index, itself included, then drops itself: atoms 0-32 keep 32 sources,
    # atoms 33-39 keep 33
    rng = np.random.default_rng(0)
    cube = mol(rng.uniform(0, 2, (40, 3)))
    got = counts.edges([line, cube], CFG, "cpu")
    assert got[0].tolist() == [4] and got[1].tolist() == [33 * 32 + 7 * 33]


def test_peaks_are_the_published_ones():
    assert (PEAK_TF32, PEAK_F32, PEAK_BYTES) == (495e12, 67e12, 3.35e12)
    assert math.isclose(counts.cfconv_least_s([(0, 0, np.array([0]))], CFG),
                        3 * 3 * 4 * (50 * 128 + 128 * 128 + 256) / PEAK_BYTES)
    assert torch.get_default_dtype() == torch.float32
