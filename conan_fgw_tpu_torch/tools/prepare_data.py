"""Dataset preparation: MoleculeNet downloads and the offline builtin
benchmarks (the port's counterpart of ``scripts/prepare_data.py``, with the
same flags and the same files).

Writes the reference's on-disk data protocol
(``conan_fgw/src/data/datasets.py:107-220``)::

    {data_root}/data/{dataset}/{train,valid,test}.csv   (smiles, <target>, mol_id)
    {data_root}/data/{dataset}/conformers_{mode}/       (one store per molecule)
    {data_root}/data/{dataset}/manifest.json

Three sources:

* ``--download <name>``: fetch the MoleculeNet CSV from its canonical
  DeepChem S3 URL, scaffold-split it 80/10/10 with the Bemis-Murcko splitter
  (the reference's protocol) and generate conformer stores. The downloaded
  file's sha256 goes into ``manifest.json``. It needs network access; a
  ``raw.csv`` already in the dataset's directory is used as it is.
* ``--builtin sol250`` / ``sol1k``: fully offline benchmarks of real
  small-molecule SMILES (``SOL250_SMILES``; ``enumerate_sol1k``'s substituent
  grid on top of it) with a computed, physically grounded surrogate target::

      logS_surrogate = 1.1 f_polar - 0.35 f_caromatic - 0.11 n_heavy
                       - 0.22 R_gyr(3D) + 0.8 f_hbond

  (polar-atom fraction, aromatic-carbon fraction, size, radius of gyration of
  the seed conformer, H-bond-capable fraction: the qualitative drivers of
  aqueous solubility in ESOL-style models). The 3D term makes the target
  depend on conformer geometry. This is not measured data. sol250 keeps the
  scaffold split, sol1k a seeded random one.
* ``--builtin sol1k_class`` / ``solflex`` / ``solflex_class`` / ``solcons``:
  datasets derived from the written ``data/sol1k`` (``prepare_derived``),
  sharing its conformer stores through symlinks.

Plain numpy and the port's data layer: ``--builtin sol250`` reproduces the
repo's ``data/sol250`` (CSVs and every ``.npz`` store) byte for byte.

Usage::

    python -m conan_fgw_tpu_torch.tools.prepare_data --builtin sol250 --data_root . --store_conformers 10
    python -m conan_fgw_tpu_torch.tools.prepare_data --download esol --data_root . --store_conformers 10
"""

from __future__ import annotations

import argparse
import csv
import hashlib
import json
import os

import numpy as np

from conan_fgw_tpu_torch.data import conformers as conf_lib
from conan_fgw_tpu_torch.data import smiles as smi
from conan_fgw_tpu_torch.data.datasets import write_csv
from conan_fgw_tpu_torch.data.splitters import RandomSplitter, ScaffoldSplitter

# Canonical MoleculeNet sources (DeepChem S3 bucket) with the column mapping
# the reference configs expect (config/schnet/*.yaml target names).
DOWNLOADS = {
    "esol": {
        "url": "https://deepchemdata.s3-us-west-1.amazonaws.com/datasets/delaney-processed.csv",
        "smiles_col": "smiles",
        "target_col": "measured log solubility in mols per litre",
        "target_name": "measured_log_sol",
        "id_col": "Compound ID",
    },
    "freesolv": {
        "url": "https://deepchemdata.s3-us-west-1.amazonaws.com/datasets/SAMPL.csv",
        "smiles_col": "smiles",
        "target_col": "expt",
        "target_name": "expt",
        "id_col": "iupac",
    },
    "lipo": {
        "url": "https://deepchemdata.s3-us-west-1.amazonaws.com/datasets/Lipophilicity.csv",
        "smiles_col": "smiles",
        "target_col": "exp",
        "target_name": "exp",
        "id_col": "CMPD_CHEMBLID",
    },
    "bace": {
        "url": "https://deepchemdata.s3-us-west-1.amazonaws.com/datasets/bace.csv",
        "smiles_col": "mol",
        "target_col": "pIC50",
        "target_name": "pIC50",
        "id_col": "CID",
    },
    "bace_class": {
        "url": "https://deepchemdata.s3-us-west-1.amazonaws.com/datasets/bace.csv",
        "smiles_col": "mol",
        "target_col": "Class",
        "target_name": "Class",
        "id_col": "CID",
    },
}

# ~250 real small molecules (common solvents, drugs, natural products and
# fragments), restricted to the organic SMILES subset the built-in parser
# covers. Entries that fail to parse or embed are dropped at prepare time.
SOL250_SMILES = [
    # --- alkanes / alkenes / alkynes ---
    "C", "CC", "CCC", "CCCC", "CCCCC", "CCCCCC", "CCCCCCC", "CCCCCCCC",
    "CC(C)C", "CC(C)(C)C", "CC(C)CC", "CCC(C)C", "CC(C)C(C)C",
    "C=C", "CC=C", "CC=CC", "CC(C)=C", "C=CC=C", "CC=CCC", "C#C", "CC#C",
    "CC#CC", "C#CC#C", "C1CC1", "C1CCC1", "C1CCCC1", "C1CCCCC1", "CC1CCCCC1",
    "C1CCCCCC1", "CC1CCCC1", "C1CC2CCC1CC2",
    # --- alcohols / ethers ---
    "CO", "CCO", "CCCO", "CCCCO", "CC(C)O", "CC(C)(C)O", "CC(O)CC",
    "OCCO", "OCC(O)CO", "CCOCC", "COC", "CCCOCC", "COCCOC", "C1CCOC1",
    "C1CCOCC1", "COCCO", "CC(C)OC(C)C", "OCC1CCCCC1", "OC1CCCCC1",
    # --- aldehydes / ketones ---
    "C=O", "CC=O", "CCC=O", "CC(C)=O", "CCC(C)=O", "CC(=O)CC", "O=C1CCCCC1",
    "CC(=O)C(C)=O", "O=CC=O", "CC(=O)CC(C)=O",
    # --- acids / esters ---
    "OC=O", "CC(O)=O", "CCC(O)=O", "CCCC(O)=O", "CC(C)C(O)=O",
    "OC(=O)C(O)=O", "OC(=O)CC(O)=O", "OC(=O)CCC(O)=O", "COC=O", "CC(=O)OC",
    "CC(=O)OCC", "CCOC(=O)C", "CCOC(=O)CC", "CC(=O)OC(C)C", "CCCCOC(C)=O",
    "COC(=O)C(C)C", "OC(=O)C=C", "CC=CC(O)=O",
    # --- amines / amides / nitriles ---
    "N", "CN", "CCN", "CCCN", "CC(C)N", "CNC", "CN(C)C", "CCNCC",
    "NCCN", "NCCO", "C1CCNCC1", "C1CCNC1", "CC(N)C", "NC1CCCCC1",
    "NC=O", "CNC=O", "CC(N)=O", "CN(C)C=O", "CNC(C)=O", "CC(=O)N(C)C",
    "C#N", "CC#N", "CCC#N", "N#CC#N", "NCC#N",
    # --- halogenated ---
    "CCl", "CC(Cl)C", "ClCCl", "ClC(Cl)Cl", "ClCCCl", "CCBr", "BrCCBr",
    "CF", "FC(F)F", "FC(F)(F)C", "CCI", "ClC=C", "ClC=CCl", "FCC(F)(F)F",
    "CC(Cl)(Cl)C", "ClCC(Cl)CCl",
    # --- thio / phospho ---
    "S", "CS", "CCS", "CSC", "CCSCC", "CSSC", "CS(C)=O", "CS(C)(=O)=O",
    "OS(O)(=O)=O", "C1CCSC1", "SC1CCCCC1", "OP(O)(O)=O", "COP(=O)(OC)OC",
    # --- nitro / misc N-O ---
    "C[N+]([O-])=O", "CC[N+]([O-])=O", "CON", "CN=O", "CNN", "NN", "NO",
    "ON=O", "CC(C)[N+]([O-])=O",
    # --- simple aromatics ---
    "c1ccccc1", "Cc1ccccc1", "CCc1ccccc1", "CC(C)c1ccccc1", "Cc1ccccc1C",
    "Cc1cccc(C)c1", "Cc1ccc(C)cc1", "CCc1ccc(CC)cc1", "Cc1ccc(C(C)C)cc1",
    "c1ccc2ccccc2c1", "Cc1ccc2ccccc2c1", "c1ccc2cc3ccccc3cc2c1",
    "C1Cc2ccccc2C1", "C1CCc2ccccc2C1", "c1ccc(-c2ccccc2)cc1",
    "C(c1ccccc1)c1ccccc1", "C=Cc1ccccc1", "C#Cc1ccccc1",
    # --- phenols / anilines / aromatic O,N ---
    "Oc1ccccc1", "Cc1ccccc1O", "Cc1ccc(O)cc1", "Oc1ccc(O)cc1",
    "Oc1cccc(O)c1", "Oc1ccccc1O", "COc1ccccc1", "COc1ccc(OC)cc1",
    "Nc1ccccc1", "CNc1ccccc1", "CN(C)c1ccccc1", "Nc1ccc(N)cc1",
    "Nc1ccccc1O", "Nc1ccc(O)cc1", "COc1ccccc1N",
    # --- aromatic halides / nitro ---
    "Clc1ccccc1", "Clc1ccc(Cl)cc1", "Clc1cccc(Cl)c1", "Clc1ccccc1Cl",
    "Brc1ccccc1", "Fc1ccccc1", "Fc1ccc(F)cc1", "Ic1ccccc1",
    "O=[N+]([O-])c1ccccc1", "Cc1ccccc1[N+]([O-])=O",
    "O=[N+]([O-])c1ccc(Cl)cc1", "Nc1ccc([N+]([O-])=O)cc1",
    # --- benzoic family / aromatic carbonyls ---
    "OC(=O)c1ccccc1", "COC(=O)c1ccccc1", "CCOC(=O)c1ccccc1",
    "OC(=O)c1ccccc1O", "CC(=O)c1ccccc1", "O=Cc1ccccc1", "O=Cc1ccc(O)cc1",
    "NC(=O)c1ccccc1", "OC(=O)c1ccc(N)cc1", "OC(=O)c1ccc(O)cc1",
    "CC(=O)Nc1ccccc1", "CC(=O)Oc1ccccc1C(O)=O",  # aspirin
    "CC(=O)Nc1ccc(O)cc1",  # paracetamol
    "N#Cc1ccccc1", "OCc1ccccc1", "NCc1ccccc1", "OCCc1ccccc1",
    # --- heteroaromatics ---
    "c1ccncc1", "Cc1ccncc1", "c1ccnc(N)c1", "c1cc[nH]c1", "Cc1ccc[nH]1",
    "c1ccoc1", "Cc1ccco1", "O=Cc1ccco1", "c1ccsc1", "Cc1cccs1",
    "c1cnccn1", "c1cncnc1", "c1cnncc1", "Nc1ncccn1", "c1ccc2[nH]ccc2c1",
    "c1ccc2occc2c1", "c1ccc2sccc2c1", "c1ccc2ncccc2c1", "c1ccc2c(c1)cccn2",
    "Cc1nccn1C", "c1ncc[nH]1", "Cc1ncc[nH]1", "c1ocnc1", "c1scnc1",
    "Cc1nc2ccccc2[nH]1", "Oc1ccncc1", "Nc1ccncc1", "OC(=O)c1ccncc1",
    # --- drugs / naturals (parser-safe subset) ---
    "CN1CCC[C@H]1c1cccnc1",  # nicotine
    "Cn1cnc2c1c(=O)n(C)c(=O)n2C",  # caffeine
    "CC(C)Cc1ccc(cc1)C(C)C(O)=O",  # ibuprofen
    "COc1ccc2cc(ccc2c1)C(C)C(O)=O",  # naproxen
    "OC(=O)Cc1ccccc1",  # phenylacetic acid
    "NC(Cc1ccccc1)C(O)=O",  # phenylalanine
    "NC(Cc1ccc(O)cc1)C(O)=O",  # tyrosine
    "NC(CO)C(O)=O",  # serine
    "NC(C)C(O)=O",  # alanine
    "NCC(O)=O",  # glycine
    "NC(CC(C)C)C(O)=O",  # leucine
    "NC(CS)C(O)=O",  # cysteine
    "NC(CCSC)C(O)=O",  # methionine
    "OC(=O)C1CCCN1",  # proline
    "NC(CC(O)=O)C(O)=O",  # aspartic acid
    "NC(CCC(O)=O)C(O)=O",  # glutamic acid
    "NC(=O)CC(N)C(O)=O",  # asparagine
    "OCC(O)C(O)C(O)C(O)CO",  # sorbitol
    "OCC1OC(O)C(O)C(O)C1O",  # glucose (pyranose)
    "CC(O)C(O)=O",  # lactic acid
    "OC(CC(O)=O)(CC(O)=O)C(O)=O",  # citric acid
    "OC(=O)C=CC(O)=O",  # fumaric/maleic
    "OC(C(O)C(O)=O)C(O)=O",  # tartaric acid
    "OCC(O)CO",  # glycerol
    "CC(=O)OCC(COC(C)=O)OC(C)=O",  # triacetin
    "CC12CCC(CC1)C(C)(C)O2",  # eucalyptol
    "CC1=CCC(CC1)C(C)=C",  # limonene
    "CC(C)=CCCC(C)=CCO",  # geraniol
    "CC1CCC(C(C)C)C(O)C1",  # menthol
    "CC(C)C1CCC(C)CC1=O",  # menthone
    "Oc1ccc(C=CC(O)=O)cc1",  # p-coumaric acid
    "COc1cc(C=O)ccc1O",  # vanillin
    "C=CCc1ccc(O)c(OC)c1",  # eugenol
    "CC(=O)C1CCC2C1(C)CCC1C2CCC2=CC(=O)CCC12C",  # progesterone
    "CN1CCc2cccc3c2C1Cc1ccc(O)c(O)c1-3",  # apomorphine-like
    "CNC(C)Cc1ccccc1",  # methamphetamine scaffold
    "NC(C)Cc1ccccc1",  # amphetamine
    "CNCC(O)c1ccc(O)c(O)c1",  # adrenaline
    "NCC(O)c1ccc(O)c(O)c1",  # noradrenaline
    "NCCc1ccc(O)c(O)c1",  # dopamine
    "NCCc1c[nH]c2ccccc12",  # tryptamine
    "CN(C)CCc1c[nH]c2ccccc12",  # DMT
    "NC(Cc1c[nH]c2ccccc12)C(O)=O",  # tryptophan
    "OCCc1c[nH]cn1",  # histidinol fragment
    "NCCc1c[nH]cn1",  # histamine
    "OC(=O)c1cc(O)c(O)c(O)c1",  # gallic acid
    "Oc1cc(O)c2c(c1)OC(c1ccc(O)c(O)c1)C(O)C2",  # catechin
    "CC(CS)C(=O)N1CCCC1C(O)=O",  # captopril
    "CC(N)Cc1ccc(O)cc1",  # tyramine-like
    "NCCc1ccc(O)cc1",  # tyramine
    "CN1C2CCC1CC(C2)OC(=O)C(CO)c1ccccc1",  # atropine
    "COC(=O)C1C2CCC(CC1OC(=O)c1ccccc1)N2C",  # cocaine
    "CCN(CC)CC(=O)Nc1c(C)cccc1C",  # lidocaine
    "CC(C)NCC(O)COc1ccc(CC(N)=O)cc1",  # atenolol
    "CC(C)NCC(O)COc1cccc2ccccc12",  # propranolol
    "Clc1ccccc1C1=NCC(=O)Nc2ccc(cc12)[N+]([O-])=O",  # nitrazepam-like
    "OC(=O)CCc1ccccc1", "OC(=O)CCCc1ccccc1",
    "COc1ccccc1OC", "Oc1ccc(Cl)cc1", "Oc1ccc(Br)cc1",
    "Oc1ccc(cc1)[N+]([O-])=O", "Oc1ccc(C)cc1C", "Clc1ccc(Cl)c(Cl)c1",
    "Clc1cc(Cl)c(Cl)cc1Cl", "Cc1ccccc1Cl", "Cc1ccc(Cl)cc1",
    "Nc1ccc(Cl)cc1", "Nc1ccccc1Cl", "Nc1ccccc1C", "Nc1ccc(C)cc1",
    "CCOc1ccccc1", "CCOc1ccc(N)cc1", "CCN(CC)c1ccccc1",
    "OCC(NC(=O)C(Cl)Cl)C(O)c1ccc(cc1)[N+]([O-])=O",  # chloramphenicol
    "CC(C)(C)NCC(O)c1ccc(O)c(CO)c1",  # salbutamol
    "CC(C)(C)NCC(O)COc1cccc2c1CC(O)C2",  # carteolol-like fragment
    "CN1CCN(CC1)c1ccccc1", "O=C1CCCN1C", "O=C1CCCN1",  # NMP, pyrrolidone
    "O=C1CCCCN1", "O=C1CCCCCN1",  # caprolactam
    "CC1(C)OC(=O)NC1=O",  # dimethylhydantoin-like
    "O=C1NC(=O)NC(=O)C1", "CCC1(CC)C(=O)NC(=O)NC1=O",  # barbiturates
    "O=c1[nH]c(=O)c2[nH]cnc2[nH]1",  # xanthine
    "Cn1cnc2c1c(=O)[nH]c(=O)n2C",  # theophylline-like
    "Nc1nc2[nH]cnc2c(=O)[nH]1",  # guanine
    "Nc1ccn(C)c(=O)n1",  # cytosine-like
    "Cc1c[nH]c(=O)[nH]c1=O",  # thymine
    "O=c1cc[nH]c(=O)[nH]1",  # uracil
    "Nc1ncnc2[nH]cnc12",  # adenine
]

# --- sol1k: programmatic enumeration on top of the curated sol250 list -------

_S1K_SUBS = [
    "O", "N", "F", "Cl", "Br", "C#N", "C=O", "C(C)=O", "C(O)=O",
    "OC", "CO", "N(C)C", "NC", "S", "SC", "OC(C)=O", "C(N)=O",
]
# substituents writable in SMILES prefix form (for para-aromatic patterns)
_S1K_PREFIX = {
    "O": "O", "N": "N", "F": "F", "Cl": "Cl", "Br": "Br",
    "C": "C", "OC": "CO", "C#N": "N#C", "C=O": "O=C",
}
_S1K_DI = ["O", "N", "Cl", "C#N", "C(O)=O"]


def _graph_key(smiles: str):
    """Dedupe key: 4 rounds of WL refinement over the H-added molecular graph
    (atomic number, aromaticity, bond orders). Symmetric rewritings of the
    same molecule (``CC(O)CC`` vs ``CCC(O)C``) collapse to one key; WL is only
    a near-canonical invariant, but at these sizes collisions are negligible
    and a collision merely drops one enumerated molecule."""
    mol = smi.add_hydrogens(smi.parse_smiles(smiles))
    lab = [hash((a.z, a.aromatic)) & 0xFFFFFFFF for a in mol.atoms]
    for _ in range(4):
        lab = [
            hash((lab[i], tuple(sorted((lab[j], b.order) for j, b in mol.neighbors(i)))))
            & 0xFFFFFFFF
            for i in range(len(mol.atoms))
        ]
    return hash(tuple(sorted(lab)))


def enumerate_sol1k() -> list:
    """~1.1-1.3k unique molecules: the sol250 list plus a scaffold ×
    substituent × position grid over alkane chains, saturated rings, and
    (hetero)aromatic cores. Entries the built-in parser/embedder rejects are
    dropped downstream by ``surrogate_logS``; WL-duplicate rewritings are
    removed here so the scaffold splitter sees each molecule once."""
    raw = list(SOL250_SMILES)
    # mono-substituted chains, every attachment position
    for n in range(2, 9):
        for i in range(1, n):
            for s in _S1K_SUBS:
                raw.append("C" * i + f"({s})" + "C" * (n - i))
    # di-substituted chains, distinct positions, polar/halogen set
    for n in range(3, 7):
        for i in range(1, n):
            for j in range(i + 1, n):
                for si in _S1K_DI:
                    for sj in _S1K_DI:
                        raw.append(
                            "C" * i + f"({si})" + "C" * (j - i) + f"({sj})" + "C" * (n - j)
                        )
    # mono-substituted (hetero)aromatic and saturated cores, branch position
    for core_pre, core_post in [
        ("c1ccc(", ")cc1"),      # benzene
        ("c1ccnc(", ")c1"),      # pyridine (2-sub)
        ("c1ccc(", ")nc1"),      # pyridine (3-sub)
        ("c1coc(", ")c1"),       # furan
        ("c1csc(", ")c1"),       # thiophene
        ("c1cc(", ")[nH]c1"),    # pyrrole
        ("C1CCC(", ")CC1"),      # cyclohexane
        ("C1CC(", ")C1"),        # cyclobutane
        ("C1CCOC(", ")C1"),      # tetrahydropyran
        ("C1CCN(", ")CC1"),      # piperidine (N-sub)
    ]:
        for s in _S1K_SUBS:
            raw.append(core_pre + s + core_post)
    # di-substituted benzenes: ortho / meta (branch-branch), para (prefix-branch)
    for a in _S1K_DI:
        for b in _S1K_DI:
            raw.append(f"c1ccc({a})c({b})c1")   # ortho
            raw.append(f"c1cc({a})cc({b})c1")   # meta
    for pa, pre in _S1K_PREFIX.items():
        for b in _S1K_SUBS:
            raw.append(f"{pre}c1ccc({b})cc1")   # para
    # naphthalene / indole / benzofuran mono-substitutions
    for pre, post in [
        ("c1ccc2ccc(", ")cc2c1"),    # 2-substituted naphthalene
        ("c1ccc2[nH]c(", ")cc2c1"),  # 2-substituted indole
        ("c1ccc2oc(", ")cc2c1"),     # 2-substituted benzofuran
    ]:
        for s in _S1K_DI + ["C", "OC"]:
            raw.append(pre + s + post)
    out, seen = [], set()
    for s in raw:
        try:
            key = _graph_key(s)
        except Exception:  # noqa: BLE001 — parser rejects; surrogate would too
            continue
        if key in seen:
            continue
        seen.add(key)
        out.append(s)
    return out


def _heavy_stats(smiles: str):
    mol = smi.parse_smiles(smiles)
    z = [a.z for a in mol.atoms]
    n_heavy = sum(1 for x in z if x > 1)
    n_polar = sum(1 for x in z if x in (7, 8))
    n_caromatic = sum(1 for a in mol.atoms if a.z == 6 and a.aromatic)
    molh = smi.add_hydrogens(mol)
    # H-bond-capable: N/O with at least one H
    hb = 0
    for i, a in enumerate(molh.atoms):
        if a.z in (7, 8) and any(molh.atoms[j].z == 1 for j, _ in molh.neighbors(i)):
            hb += 1
    return n_heavy, n_polar, n_caromatic, hb, molh


def surrogate_logS(smiles: str, seed: int = 7) -> float:
    """Physically-grounded surrogate solubility (see module docstring)."""
    n_heavy, n_polar, n_carom, hb, molh = _heavy_stats(smiles)
    pos = conf_lib.dg_generate(molh, 1, seed=seed)[0]
    rgyr = float(np.sqrt(np.mean(np.sum((pos - pos.mean(0)) ** 2, axis=1))))
    return float(
        1.1 * n_polar / n_heavy
        - 0.35 * n_carom / max(n_heavy, 1)
        - 0.11 * n_heavy
        - 0.22 * rgyr
        + 0.8 * hb / max(n_heavy, 1)
    )


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _split_and_write(rows, dataset_dir, target_name, store_conformers, workers, prune,
                     splitter=None):
    """Split rows (scaffold by default), write CSVs, generate conformer stores."""
    splitter = splitter or ScaffoldSplitter()
    smiles_list = [r["smiles"] for r in rows]
    tr, va, te = splitter.split(smiles_list, 0.8, 0.1, 0.1)
    splits = {"train": tr, "valid": va, "test": te}
    for mode, idx in splits.items():
        subset = [rows[i] for i in idx]
        write_csv(os.path.join(dataset_dir, f"{mode}.csv"), subset, target=target_name)
        failed = conf_lib.generate_store(
            [r["smiles"] for r in subset],
            [r["mol_id"] for r in subset],
            os.path.join(dataset_dir, f"conformers_{mode}"),
            store_conformers,
            prune=prune,
            max_workers=workers,
        )
        print(f"{mode}: {len(subset)} molecules, {len(failed)} conformer failures")
        for mid, err in failed:
            print(f"  FAILED {mid}: {err}")
    return splits


def prepare_builtin(name, data_root, store_conformers, workers):
    sources = {"sol250": lambda: SOL250_SMILES, "sol1k": enumerate_sol1k}
    assert name in sources, f"unknown builtin dataset {name!r}"
    smiles_source = sources[name]()
    dataset_dir = os.path.join(data_root, "data", name)
    os.makedirs(dataset_dir, exist_ok=True)
    rows, dropped = [], []
    seen = set()
    for i, s in enumerate(smiles_source):
        if s in seen:
            continue
        seen.add(s)
        try:
            y = surrogate_logS(s)
        except Exception as e:  # noqa: BLE001 — parser/embedder coverage filter
            dropped.append((s, repr(e)))
            continue
        # sol250 predates the {name}_ prefix: keep its legacy 'sol' prefix so
        # re-running --builtin sol250 reproduces the committed data/sol250
        # store byte-for-byte (CSV mol_ids and conformer .npz filenames)
        prefix = "sol" if name == "sol250" else name + "_"
        rows.append({"smiles": s, "y": y, "mol_id": f"{prefix}{i:04d}"})
    print(f"{name}: {len(rows)} molecules ({len(dropped)} dropped)")
    for s, err in dropped:
        print(f"  DROPPED {s}: {err}")
    # sol1k is a substituent-enumerated library: Murcko/WL scaffolds are
    # degenerate (every acyclic molecule shares the empty scaffold, every
    # substituted benzene the benzene one), so a greedy scaffold split
    # collapses (1028/228/29 observed). A seeded random split keeps the
    # 80/10/10 protocol statistically meaningful; sol250's curated list
    # keeps the reference's scaffold split.
    splitter = RandomSplitter() if name == "sol1k" else None
    splits = _split_and_write(
        rows, dataset_dir, "logS_surrogate", store_conformers, workers, prune=False,
        splitter=splitter,
    )
    ys = np.asarray([r["y"] for r in rows])
    manifest = {
        "dataset": name,
        "source": "builtin (offline surrogate; see scripts/prepare_data.py)",
        "n_molecules": len(rows),
        "target": "logS_surrogate",
        "target_mean": float(ys.mean()),
        "target_std": float(ys.std()),
        "splits": {k: len(v) for k, v in splits.items()},
        "split_method": "random(seed=42)" if name == "sol1k" else "scaffold",
        "store_conformers": store_conformers,
    }
    with open(os.path.join(dataset_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    print(json.dumps(manifest, indent=2))


def conformer_spectral_dispersion(positions) -> float:
    """Cross-conformer structural dispersion of one molecule's ensemble.

    For each stored conformer c, ``D_c`` is the n×n Euclidean distance matrix
    and ``λ(D_c)`` its sorted eigenvalue spectrum — a permutation-invariant
    structural summary (spectra are Gromov-Wasserstein invariants). The
    dispersion is the mean over conformer pairs of the per-atom-normalised
    spectral distance ``‖λ(D_c) − λ(D_c')‖₂ / n``: a cheap symmetric
    surrogate for the ensemble's pairwise GW dispersion, i.e. how much the
    molecule's 3D *structure* (not any per-conformer scalar) varies across
    its conformers.
    """
    P = np.asarray(positions, dtype=np.float64)  # (C, n, 3)
    diff = P[:, :, None, :] - P[:, None, :, :]
    D = np.sqrt((diff**2).sum(-1))  # (C, n, n)
    spectra = np.sort(np.linalg.eigvalsh(D), axis=-1)  # (C, n)
    n_conf, n = spectra.shape
    pair_d = np.linalg.norm(spectra[:, None, :] - spectra[None, :, :], axis=-1) / n
    iu = np.triu_indices(n_conf, k=1)
    return float(pair_d[iu].mean()) if iu[0].size else 0.0


def conformer_consensus_deviation(positions) -> float:
    """Mean spectral deviation of each conformer from the ensemble consensus.

    The consensus structure is the mean distance matrix ``D̄`` over stored
    conformers; the target is ``mean_c ‖λ(D̄) − λ(D_c)‖₂ / n`` — a 1-vs-mean
    structural deviation, distinct from the pairwise U-statistic of
    ``conformer_spectral_dispersion`` (same invariance class, different
    functional — used to test that the solflex dose-response is not a quirk
    of one label definition).
    """
    P = np.asarray(positions, dtype=np.float64)  # (C, n, 3)
    diff = P[:, :, None, :] - P[:, None, :, :]
    D = np.sqrt((diff**2).sum(-1))  # (C, n, n)
    Dbar = D.mean(axis=0)
    lam_bar = np.sort(np.linalg.eigvalsh(Dbar))
    lam = np.sort(np.linalg.eigvalsh(D), axis=-1)  # (C, n)
    n = lam.shape[-1]
    return float(np.linalg.norm(lam - lam_bar[None, :], axis=-1).mean() / n)


def prepare_derived(name, data_root):
    """Builtins derived from the committed sol1k store (no regeneration):

    * ``sol1k_class`` — binary-classification twin: ``Class = 1`` iff
      ``logS_surrogate`` is above the train split's 75th percentile (~1:3
      imbalance, the BACE-like regime the reference's weighted-BCE path
      targets, ``common.py:210-217``). Same molecules, splits, and conformer
      stores (symlinked).
    * ``solflex`` — cross-conformer structural-signal regression: the target
      is ``conformer_spectral_dispersion`` over the SAME 10-conformer store
      the training path resamples K from, standardised by train-split stats.
      Unlike ``logS_surrogate`` (whose 3D term is a per-conformer scalar a
      K-mean already averages), this target is an order-2 U-statistic over
      conformer *pairs* — a mechanism that structurally compares conformers
      to each other (the FGW barycenter branch) is architecturally matched
      to it; a mean of per-conformer embeddings is not.
    * ``solflex_class`` — discriminative binary twin of solflex: ``Class =
      1`` iff the dispersion is above the train split's MEDIAN (balanced — boundary molecules are genuinely ambiguous, so the
      ROC has headroom, unlike the ceiling-saturated sol1k_class). The
      label depends on cross-conformer structure, so this task can
      adjudicate the FGW branch for classification.
    * ``solcons`` — consensus-structure regression: the
      target is the mean per-atom-normalised spectral distance between each
      conformer and the ensemble's CONSENSUS distance matrix (the mean
      ``D̄`` over conformers) — dispersion *about the consensus* rather
      than the pairwise U-statistic, i.e. a second, independent definition
      of cross-conformer structural signal to test whether the solflex
      dose-response generalises across label definitions.
    """
    assert name in ("sol1k_class", "solflex", "solflex_class", "solcons")
    base_dir = os.path.join(data_root, "data", "sol1k")
    if not os.path.isdir(base_dir):
        raise FileNotFoundError(
            f"{base_dir} not found: run `prepare_data --builtin sol1k` first"
        )
    dataset_dir = os.path.join(data_root, "data", name)
    os.makedirs(dataset_dir, exist_ok=True)

    split_rows = {}
    for mode in ("train", "valid", "test"):
        with open(os.path.join(base_dir, f"{mode}.csv"), newline="") as f:
            split_rows[mode] = [
                {"smiles": r["smiles"], "y": float(r["logS_surrogate"]),
                 "mol_id": r["mol_id"]}
                for r in csv.DictReader(f)
            ]
        # share the conformer stores via a relative symlink
        link = os.path.join(dataset_dir, f"conformers_{mode}")
        if not os.path.lexists(link):
            os.symlink(os.path.join("..", "sol1k", f"conformers_{mode}"), link)

    if name == "sol1k_class":
        target_name = "Class"
        thresh = float(np.percentile([r["y"] for r in split_rows["train"]], 75))
        for mode, rows in split_rows.items():
            for r in rows:
                r["y"] = int(r["y"] > thresh)
        extra = {
            "threshold_logS": thresh,
            "train_pos_frac": float(np.mean([r["y"] for r in split_rows["train"]])),
        }
    else:
        struct_fn = (
            conformer_consensus_deviation if name == "solcons"
            else conformer_spectral_dispersion
        )
        for mode, rows in split_rows.items():
            for r in rows:
                pos = conf_lib.load_store(
                    os.path.join(base_dir, f"conformers_{mode}"), r["mol_id"]
                )
                r["y"] = struct_fn(pos)
        if name == "solflex_class":
            target_name = "Class"
            thresh = float(np.median([r["y"] for r in split_rows["train"]]))
            for mode, rows in split_rows.items():
                for r in rows:
                    r["y"] = int(r["y"] > thresh)
            extra = {
                "threshold_dispersion": thresh,
                "train_pos_frac": float(
                    np.mean([r["y"] for r in split_rows["train"]])
                ),
            }
        else:
            target_name = (
                "cons_surrogate" if name == "solcons" else "flex_surrogate"
            )
            mu = float(np.mean([r["y"] for r in split_rows["train"]]))
            sd = float(np.std([r["y"] for r in split_rows["train"]]))
            for rows in split_rows.values():
                for r in rows:
                    r["y"] = (r["y"] - mu) / sd
            extra = {"train_dispersion_mean": mu, "train_dispersion_std": sd}

    for mode, rows in split_rows.items():
        write_csv(os.path.join(dataset_dir, f"{mode}.csv"), rows, target=target_name)
    manifest = {
        "dataset": name,
        "source": "derived from builtin sol1k (see prepare_derived docstring)",
        "target": target_name,
        "splits": {k: len(v) for k, v in split_rows.items()},
        "conformers": "symlinked to data/sol1k",
        **extra,
    }
    with open(os.path.join(dataset_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    print(json.dumps(manifest, indent=2))


def prepare_download(name, data_root, store_conformers, workers, prune):
    spec = DOWNLOADS[name]
    dataset_dir = os.path.join(data_root, "data", name)
    os.makedirs(dataset_dir, exist_ok=True)
    raw_path = os.path.join(dataset_dir, "raw.csv")
    if not os.path.exists(raw_path):
        import urllib.request

        print(f"downloading {spec['url']}")
        urllib.request.urlretrieve(spec["url"], raw_path)
    sha = _sha256(raw_path)
    print(f"sha256({raw_path}) = {sha}")

    rows = []
    with open(raw_path, newline="") as f:
        for i, row in enumerate(csv.DictReader(f)):
            s = row[spec["smiles_col"]].strip()
            if not s:
                continue
            mid = str(row.get(spec["id_col"], i)).strip() or str(i)
            rows.append({"smiles": s, "y": float(row[spec["target_col"]]), "mol_id": mid})
    splits = _split_and_write(
        rows, dataset_dir, spec["target_name"], store_conformers, workers, prune
    )
    manifest = {
        "dataset": name,
        "source": spec["url"],
        "sha256": sha,
        "n_molecules": len(rows),
        "target": spec["target_name"],
        "splits": {k: len(v) for k, v in splits.items()},
        "split_method": "random(seed=42)" if name == "sol1k" else "scaffold",
        "store_conformers": store_conformers,
    }
    with open(os.path.join(dataset_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    print(json.dumps(manifest, indent=2))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    g = ap.add_mutually_exclusive_group(required=True)
    g.add_argument("--download", choices=sorted(DOWNLOADS))
    g.add_argument("--builtin", choices=["sol250", "sol1k", "sol1k_class", "solflex",
                                         "solflex_class", "solcons"])
    ap.add_argument("--data_root", default=".")
    ap.add_argument(
        "--store_conformers", type=int, default=10,
        help="conformers per molecule in the store (> K so per-epoch "
        "resampling engages)",
    )
    ap.add_argument("--workers", type=int, default=None,
                    help="processes embedding conformers (default: the CPU count)")
    ap.add_argument("--prune", action="store_true", help="RDKit pruneRmsThresh=0.5")
    args = ap.parse_args(argv)
    if args.builtin in ("sol1k_class", "solflex", "solflex_class", "solcons"):
        prepare_derived(args.builtin, args.data_root)
    elif args.builtin:
        prepare_builtin(args.builtin, args.data_root, args.store_conformers, args.workers)
    else:
        prepare_download(
            args.download, args.data_root, args.store_conformers, args.workers, args.prune
        )


if __name__ == "__main__":
    main()
