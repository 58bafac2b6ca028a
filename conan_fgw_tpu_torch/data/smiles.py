"""Self-contained SMILES parser + featuriser (no RDKit dependency); the
port's own copy of ``conan_fgw_tpu/data/smiles.py``, which it must match
array for array.

The reference delegates all chemistry to RDKit
(``conan_fgw/src/data/conformers/features.py:196-205`` uses PyG
``from_smiles(with_hydrogen=True)``). This module is a built-in toolchain:
a SMILES reader for the organic subset + bracket atoms, implicit-hydrogen
completion by standard valence rules, ring perception, and featurisation
into the categorical tables of ``data/vocab.py``. Deviations from RDKit
(approximate hybridisation/conjugation perception, no kekulisation) are
documented inline.
"""

from __future__ import annotations

import dataclasses
import math
import re

import numpy as np

from conan_fgw_tpu_torch.data import vocab

_ORGANIC = ["Cl", "Br", "B", "C", "N", "O", "P", "S", "F", "I"]
_AROMATIC = ["b", "c", "n", "o", "p", "s"]

_ELEMENTS = {
    "H": 1, "He": 2, "Li": 3, "Be": 4, "B": 5, "C": 6, "N": 7, "O": 8, "F": 9,
    "Ne": 10, "Na": 11, "Mg": 12, "Al": 13, "Si": 14, "P": 15, "S": 16,
    "Cl": 17, "Ar": 18, "K": 19, "Ca": 20, "Fe": 26, "Co": 27, "Ni": 28,
    "Cu": 29, "Zn": 30, "As": 33, "Se": 34, "Br": 35, "I": 53,
}

# default valences for implicit-H completion (OpenSMILES)
_VALENCE = {5: (3,), 6: (4,), 7: (3, 5), 8: (2,), 15: (3, 5), 16: (2, 4, 6),
            9: (1,), 17: (1,), 35: (1,), 53: (1,)}

_BOND_ORDER = {"-": 1.0, "=": 2.0, "#": 3.0, "$": 4.0, ":": 1.5, "/": 1.0, "\\": 1.0}
_BOND_CODE = {1.0: vocab.BOND_SINGLE, 2.0: vocab.BOND_DOUBLE, 3.0: vocab.BOND_TRIPLE,
              1.5: vocab.BOND_AROMATIC, 4.0: vocab.BOND_TYPES.index("QUADRUPLE")}


@dataclasses.dataclass
class Atom:
    z: int
    aromatic: bool = False
    charge: int = 0
    explicit_h: int = -1  # -1: infer from valence
    chirality: int = 0
    isotope: int = 0


@dataclasses.dataclass
class Bond:
    i: int
    j: int
    order: float  # 1, 1.5 (aromatic), 2, 3
    in_ring: bool = False


@dataclasses.dataclass
class Molecule:
    atoms: list
    bonds: list

    @property
    def num_atoms(self):
        return len(self.atoms)

    def neighbors(self, i):
        out = []
        for b in self.bonds:
            if b.i == i:
                out.append((b.j, b))
            elif b.j == i:
                out.append((b.i, b))
        return out


class SmilesError(ValueError):
    pass


_BRACKET_RE = re.compile(
    r"^(?P<isotope>\d+)?(?P<symbol>[A-Z][a-z]?|[a-z]{1,2}|\*)"
    r"(?P<chiral>@{1,2}(?:TH\d|AL\d|SP\d|TB\d+|OH\d+)?)?"
    r"(?P<hcount>H\d*)?(?P<charge>\+{1,3}|-{1,3}|\+\d+|-\d+)?(?::(?P<map>\d+))?$"
)


def parse_smiles(s: str) -> Molecule:
    """Parse one SMILES string into a ``Molecule`` (aromatic bonds kept as 1.5)."""
    atoms: list[Atom] = []
    bonds: list[Bond] = []
    stack: list[int] = []
    prev: int | None = None
    pending_bond: float | None = None
    ring: dict[str, tuple[int, float | None]] = {}
    i, n = 0, len(s)

    def add_atom(a: Atom) -> int:
        atoms.append(a)
        return len(atoms) - 1

    def bond_to(idx: int):
        nonlocal prev, pending_bond
        if prev is not None:
            order = pending_bond
            if order is None:
                order = 1.5 if (atoms[prev].aromatic and atoms[idx].aromatic) else 1.0
            bonds.append(Bond(prev, idx, order))
        pending_bond = None
        prev = idx

    while i < n:
        c = s[i]
        if c == "[":
            j = s.index("]", i)
            m = _BRACKET_RE.match(s[i + 1 : j])
            if not m:
                raise SmilesError(f"bad bracket atom {s[i:j+1]!r} in {s!r}")
            sym = m.group("symbol")
            aromatic = sym[0].islower()
            el = sym.capitalize() if aromatic else sym
            if el == "*":
                z = 0
            elif el not in _ELEMENTS:
                raise SmilesError(f"unknown element {el!r} in {s!r}")
            else:
                z = _ELEMENTS[el]
            h = m.group("hcount")
            hcount = 0 if h is None else (1 if h == "H" else int(h[1:]))
            ch = m.group("charge") or ""
            if ch:
                if ch[-1].isdigit():
                    charge = int(ch[1:]) * (1 if ch[0] == "+" else -1)
                else:
                    charge = ch.count("+") - ch.count("-")
            else:
                charge = 0
            chiral = m.group("chiral") or ""
            chirality = 0
            if chiral.startswith("@@"):
                chirality = vocab.CHIRALITY.index("CHI_TETRAHEDRAL_CW")
            elif chiral.startswith("@"):
                chirality = vocab.CHIRALITY.index("CHI_TETRAHEDRAL_CCW")
            iso = int(m.group("isotope")) if m.group("isotope") else 0
            idx = add_atom(Atom(z, aromatic, charge, hcount, chirality, iso))
            bond_to(idx)
            i = j + 1
        elif c.isalpha():
            matched = None
            for sym in _ORGANIC:
                if s.startswith(sym, i):
                    matched = sym
                    break
            if matched:
                idx = add_atom(Atom(_ELEMENTS[matched]))
                bond_to(idx)
                i += len(matched)
            elif c in _AROMATIC:
                idx = add_atom(Atom(_ELEMENTS[c.upper()], aromatic=True))
                bond_to(idx)
                i += 1
            else:
                raise SmilesError(f"unexpected atom symbol at {s[i:]!r}")
        elif c in _BOND_ORDER:
            pending_bond = _BOND_ORDER[c]
            i += 1
        elif c == "(":
            stack.append(prev)
            i += 1
        elif c == ")":
            prev = stack.pop()
            i += 1
        elif c.isdigit() or c == "%":
            if c == "%":
                label = s[i + 1 : i + 3]
                i += 3
            else:
                label = c
                i += 1
            if label in ring:
                other, open_order = ring.pop(label)
                order = pending_bond if pending_bond is not None else open_order
                if order is None:
                    order = 1.5 if (atoms[prev].aromatic and atoms[other].aromatic) else 1.0
                bonds.append(Bond(other, prev, order))
                pending_bond = None
            else:
                ring[label] = (prev, pending_bond)
                pending_bond = None
        elif c == ".":
            prev = None
            pending_bond = None
            i += 1
        elif c in "@/\\":
            i += 1  # lone stereo markers outside brackets: ignored
        else:
            raise SmilesError(f"unexpected character {c!r} in {s!r}")
    if ring:
        raise SmilesError(f"unclosed ring bond(s) {sorted(ring)} in {s!r}")
    _perceive_rings(Molecule(atoms, bonds))
    return Molecule(atoms, bonds)


def _perceive_rings(mol: Molecule) -> None:
    """Mark ring bonds: an edge is in a ring iff it is not a bridge (Tarjan)."""
    n = mol.num_atoms
    adj: list[list[tuple[int, int]]] = [[] for _ in range(n)]
    for bi, b in enumerate(mol.bonds):
        adj[b.i].append((b.j, bi))
        adj[b.j].append((b.i, bi))
    disc = [-1] * n
    low = [0] * n
    timer = [0]

    def dfs(root):
        stack = [(root, -1, iter(adj[root]))]
        disc[root] = low[root] = timer[0]
        timer[0] += 1
        while stack:
            u, pe, it = stack[-1]
            advanced = False
            for v, bi in it:
                if bi == pe:
                    continue
                if disc[v] == -1:
                    disc[v] = low[v] = timer[0]
                    timer[0] += 1
                    stack.append((v, bi, iter(adj[v])))
                    advanced = True
                    break
                else:
                    low[u] = min(low[u], disc[v])
                    mol.bonds[bi].in_ring = True  # back edge closes a cycle
            if not advanced:
                stack.pop()
                if stack:
                    pu = stack[-1][0]
                    low[pu] = min(low[pu], low[u])
                    if low[u] > disc[pu]:
                        pass  # bridge: stays out of any ring
                    else:
                        mol.bonds[pe].in_ring = True

    for r in range(n):
        if disc[r] == -1:
            dfs(r)


def implicit_hydrogens(mol: Molecule, idx: int) -> int:
    a = mol.atoms[idx]
    if a.explicit_h >= 0:
        return a.explicit_h  # bracket atoms carry explicit H counts
    if a.z not in _VALENCE:
        return 0
    bondsum = sum(b.order for _, b in mol.neighbors(idx))
    need = math.ceil(bondsum)
    for v in _VALENCE[a.z]:
        v_adj = v + (a.charge if a.z in (7, 8, 15, 16) else -abs(a.charge))
        if need <= v_adj:
            return int(v_adj - need)
    return 0


def add_hydrogens(mol: Molecule) -> Molecule:
    """Explicit-H form (the reference featurises with ``with_hydrogen=True``)."""
    atoms = list(mol.atoms)
    bonds = list(mol.bonds)
    out = Molecule(atoms, bonds)
    for i in range(mol.num_atoms):
        for _ in range(implicit_hydrogens(mol, i)):
            h = len(out.atoms)
            out.atoms.append(Atom(1, explicit_h=0))
            out.bonds.append(Bond(i, h, 1.0))
    return out


def _hybridization(mol: Molecule, idx: int) -> int:
    """Approximate hybridisation (the RDKit path computes it exactly)."""
    a = mol.atoms[idx]
    if a.z == 1:
        return vocab.HYBRIDIZATION.index("S")
    orders = [b.order for _, b in mol.neighbors(idx)]
    if a.aromatic or any(o == 1.5 for o in orders):
        return vocab.HYBRIDIZATION.index("SP2")
    if any(o == 3.0 for o in orders) or sum(1 for o in orders if o == 2.0) >= 2:
        return vocab.HYBRIDIZATION.index("SP")
    if any(o == 2.0 for o in orders):
        return vocab.HYBRIDIZATION.index("SP2")
    return vocab.HYBRIDIZATION.index("SP3")


def featurize(mol: Molecule):
    """(x2d, bonds, bond_attr, z) arrays in the vocab coding.

    ``num_hs`` counts hydrogen neighbours + remaining implicit Hs (matching
    RDKit ``GetTotalNumHs`` semantics on an AddHs-ed molecule); conjugation
    is approximated as "aromatic or double/triple bond adjacent to another
    multiple bond".
    """
    n = mol.num_atoms
    deg = [0] * n
    h_nbrs = [0] * n
    multi = [False] * n  # atom touches a multiple bond (for conjugation approx)
    for b in mol.bonds:
        deg[b.i] += 1
        deg[b.j] += 1
        if mol.atoms[b.j].z == 1:
            h_nbrs[b.i] += 1
        if mol.atoms[b.i].z == 1:
            h_nbrs[b.j] += 1
        if b.order >= 1.5:
            multi[b.i] = multi[b.j] = True

    x2d = np.zeros((n, vocab.NUM_ATOM_FEATURES), np.int32)
    z = np.zeros((n,), np.int32)
    for i, a in enumerate(mol.atoms):
        ring = any(b.in_ring for _, b in mol.neighbors(i))
        nh = h_nbrs[i] + max(0, implicit_hydrogens(mol, i) if a.explicit_h < 0 else 0)
        x2d[i] = vocab.atom_features(
            a.z,
            chirality=a.chirality,
            degree=min(deg[i], 10),
            formal_charge=a.charge,
            num_hs=min(nh, 8),
            hybridization=_hybridization(mol, i),
            is_aromatic=a.aromatic,
            is_in_ring=ring,
        )
        z[i] = a.z

    bonds = np.zeros((len(mol.bonds), 2), np.int32)
    battr = np.zeros((len(mol.bonds), vocab.NUM_BOND_FEATURES), np.float32)
    for k, b in enumerate(mol.bonds):
        bonds[k] = (b.i, b.j)
        conj = b.order == 1.5 or (b.order >= 2.0 and multi[b.i] and multi[b.j])
        battr[k] = vocab.bond_features(_BOND_CODE[b.order], 0, conj)
    return x2d, bonds, battr, z
