"""Categorical atom/bond feature vocabularies (the port's own copy).

Index semantics match PyG's ``torch_geometric.utils.smiles`` maps, which the
reference uses via ``from_smiles`` (``conan_fgw/src/data/conformers/features.py:199``)
and mirrors in its own tables (``conan_fgw/src/model/features.py``). The GAT
branch consumes these *indices directly as floats* (``gat.py:21``), so the
exact integer coding is load-bearing for parity.

Atom feature vector (9 ints):
  [atomic_num, chirality, degree, formal_charge_idx, num_hs,
   num_radical_electrons, hybridization, is_aromatic, is_in_ring]
Bond feature vector (3 ints):
  [bond_type, stereo, is_conjugated]
"""

from __future__ import annotations

NUM_ATOM_FEATURES = 9
NUM_BOND_FEATURES = 3

CHIRALITY = [
    "CHI_UNSPECIFIED",
    "CHI_TETRAHEDRAL_CW",
    "CHI_TETRAHEDRAL_CCW",
    "CHI_OTHER",
    "CHI_TETRAHEDRAL",
    "CHI_ALLENE",
    "CHI_SQUAREPLANAR",
    "CHI_TRIGONALBIPYRAMIDAL",
    "CHI_OCTAHEDRAL",
]

HYBRIDIZATION = ["UNSPECIFIED", "S", "SP", "SP2", "SP3", "SP3D", "SP3D2", "OTHER"]

BOND_TYPES = [
    "UNSPECIFIED",
    "SINGLE",
    "DOUBLE",
    "TRIPLE",
    "QUADRUPLE",
    "QUINTUPLE",
    "HEXTUPLE",
    "ONEANDAHALF",
    "TWOANDAHALF",
    "THREEANDAHALF",
    "FOURANDAHALF",
    "FIVEANDAHALF",
    "AROMATIC",
    "IONIC",
    "HYDROGEN",
    "THREECENTER",
    "DATIVEONE",
    "DATIVE",
    "DATIVEL",
    "DATIVER",
    "OTHER",
    "ZERO",
]

BOND_STEREO = [
    "STEREONONE",
    "STEREOANY",
    "STEREOZ",
    "STEREOE",
    "STEREOCIS",
    "STEREOTRANS",
]

FORMAL_CHARGE_OFFSET = 5  # formal_charge index = charge + 5, range(-5, 7)

BOND_SINGLE = BOND_TYPES.index("SINGLE")
BOND_DOUBLE = BOND_TYPES.index("DOUBLE")
BOND_TRIPLE = BOND_TYPES.index("TRIPLE")
BOND_AROMATIC = BOND_TYPES.index("AROMATIC")


def atom_features(
    atomic_num: int,
    *,
    chirality: int = 0,
    degree: int = 0,
    formal_charge: int = 0,
    num_hs: int = 0,
    num_radical_electrons: int = 0,
    hybridization: int = 0,
    is_aromatic: bool = False,
    is_in_ring: bool = False,
) -> list[int]:
    return [
        atomic_num,
        chirality,
        degree,
        formal_charge + FORMAL_CHARGE_OFFSET,
        num_hs,
        num_radical_electrons,
        hybridization,
        int(is_aromatic),
        int(is_in_ring),
    ]


def bond_features(bond_type: int, stereo: int = 0, is_conjugated: bool = False) -> list[int]:
    return [bond_type, stereo, int(is_conjugated)]
