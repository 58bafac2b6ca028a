"""Experiment configuration from the repo's YAML files (the port's own copy
of ``conan_fgw_tpu/train/config.py``).

The reference parses YAML with jsonargparse and instantiates the
``experiment:`` dotted class path (``conan_fgw/src/config_parser.py:37-61``,
``src/experiments.py:20-80``). Here reference class paths map onto an
experiment registry describing task type, barycenter usage, and dataset
flavour.

The port reads YAML with its own parser, ``parse_yaml``, since the machines
it runs on need not have PyYAML. It takes the subset that ``config/**/*.yaml``
uses and resolves scalars as PyYAML's YAML 1.1 rules do:

- comments, blank lines and top-level ``key: value`` lines;
- scalars: decimal integers, floats written with a dot, booleans, null,
  quoted strings without escapes, and plain strings;
- one-line flow lists of scalars (``['sol250']``) and flow maps of scalars
  (``{min_delta: 0.0001, patience: 50}``).

Anything else (indented blocks, block lists, anchors, tags, multi-document
markers, and scalars that YAML 1.1 reads in a way plain Python would not,
such as ``1e-4``, ``0x10`` or ``1_000``) raises a ``ValueError`` naming the
file and line.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    """What the reference's experiment dataclasses encode."""

    task: str  # "regression" | "classification"
    barycenter: bool  # stage-2 model uses the FGW branch
    dataset: str = "conformers"  # "conformers" | "geom" | "smiles"
    model: str = "conan"  # fusion head family


EXPERIMENTS: dict[str, ExperimentSpec] = {
    # reference dotted paths (config-file compatibility)
    "conan_fgw.src.experiments.SOTAExperiment": ExperimentSpec("regression", False),
    "conan_fgw.src.experiments.SOTAExperimentBaryCenter": ExperimentSpec("regression", True),
    "conan_fgw.src.experiments.SOTAClassificationExperiment": ExperimentSpec(
        "classification", False
    ),
    "conan_fgw.src.experiments.SOTAClassificationExperimentBaryCenter": ExperimentSpec(
        "classification", True
    ),
    "conan_fgw.src.experiments.SOTAClassificationGEOMExperiment": ExperimentSpec(
        "classification", False, dataset="geom"
    ),
    "conan_fgw.src.experiments.SOTAClassificationGEOMExperimentBaryCenter": ExperimentSpec(
        "classification", True, dataset="geom"
    ),
    "conan_fgw.src.experiments.TrialsExperiment": ExperimentSpec("regression", False),
    "conan_fgw.src.experiments.DimeNetGEOMExperiment": ExperimentSpec(
        "regression", False, dataset="geom"
    ),
    "conan_fgw.src.experiments.GATExperiment": ExperimentSpec(
        "regression", False, model="gat_only"
    ),
    # native short names
    "regression": ExperimentSpec("regression", False),
    "regression_bc": ExperimentSpec("regression", True),
    "classification": ExperimentSpec("classification", False),
    "classification_bc": ExperimentSpec("classification", True),
    # aux-head families (models/aux_heads.py of the JAX package)
    "gat_only": ExperimentSpec("regression", False, model="gat_only"),
    "scalars": ExperimentSpec("regression", False, model="scalars"),
    "embeddings": ExperimentSpec("regression", False, model="embeddings"),
    "covalent": ExperimentSpec("regression", False, model="covalent"),
    "attention": ExperimentSpec("regression", False, model="attention"),
    "esan_avg_conf": ExperimentSpec("regression", False, model="esan:avg_conf_esan"),
    "esan_geometry": ExperimentSpec(
        "regression", False, model="esan:geometry_induced_esan"
    ),
    "esan_geometry_2d": ExperimentSpec(
        "regression", False, model="esan:geometry_2d_induced_esan"
    ),
}


@dataclasses.dataclass
class ExperimentConfig:
    """Typed view of one YAML config (keys per ``config_parser.py:37-61``);
    the same fields and defaults as the JAX package's."""

    dataset_name: list
    target: list
    num_conformers: int
    batch_size: int
    experiment: str
    num_epochs: int
    learning_rate: float
    es_min_delta: float = 1e-4
    es_patience: int = 50
    disable_distribution: bool = False
    dummy_size: int = -1
    prune_conformers: bool = False
    use_lr_finder: bool = False
    use_wandb: bool = False
    agg_weight: float = 0.2
    max_iter: int = 100  # the reference hardcodes 5 in the hot path
    epsilon: float = 0.1
    # opt-in: thread max_iter/epsilon into the FGW solver (the reference
    # never does; the hardcoded 5/5/5, eps=0.1 is the default)
    fgw_from_config: bool = False
    fgw_pgd_iters: Optional[int] = None
    fgw_sinkhorn_iters: Optional[int] = None
    trade_off: bool = False
    model_name: str = "schnet"
    max_atoms: Optional[int] = None
    bary_pad_mode: str = "reference"
    neighbor_cap_mode: str = "index"
    # the kernels of the cfconv and of the FGW couplings: None or true runs
    # them (the CUDA kernels in the port); false asks for the plain versions,
    # which the port keeps for the CPU only and refuses on the card
    use_pallas_cfconv: Optional[bool] = None
    use_pallas_fgw: Optional[bool] = None
    compute_dtype: str = "float32"
    # the JAX package's scan-chunked training; the port runs every fit's
    # train and eval steps as CUDA graphs on the card, whatever its value
    scan_chunk: int = 0
    eval_guard: bool = False

    @property
    def spec(self) -> ExperimentSpec:
        try:
            return EXPERIMENTS[self.experiment]
        except KeyError:
            raise KeyError(
                f"unknown experiment {self.experiment!r}; known: {sorted(EXPERIMENTS)}"
            )


# YAML 1.1 scalar forms (PyYAML's implicit resolvers), as far as the subset
# takes them
_BOOL = {"yes": True, "Yes": True, "YES": True, "true": True, "True": True, "TRUE": True,
         "on": True, "On": True, "ON": True, "no": False, "No": False, "NO": False,
         "false": False, "False": False, "FALSE": False, "off": False, "Off": False,
         "OFF": False}
_NULL = {"", "~", "null", "Null", "NULL"}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9]*)")
_FLOAT = re.compile(r"[-+]?(?:[0-9]+\.[0-9]*|\.[0-9]+)(?:[eE][-+][0-9]+)?")
# anything else that starts like a number: YAML 1.1 reads such scalars in
# ways plain Python would not (octal 007, 0x10, 1_000, 1:30, .inf,
# timestamps, and 1e-4 as a string)
_REFUSED = re.compile(r"[-+]?\.?[0-9].*|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN)")
_KEY = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")
_INDICATORS = "[]{}&*!|>%@`,?:#-"


def _strip_comment(line: str) -> str:
    """``line`` without its comment: a ``#`` at the start or after a space,
    outside quotes."""
    quote = None
    for i, c in enumerate(line):
        if quote:
            if c == quote:
                quote = None
        elif c in "'\"":
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _scalar(text: str, where: str):
    s = text.strip()
    if len(s) >= 2 and s[0] == s[-1] and s[0] in "'\"":
        body = s[1:-1]
        if s[0] == "'":
            if re.search(r"(?<!')'(?!')", body.replace("''", "")):
                raise ValueError(f"{where}: unbalanced quote in {s!r}")
            return body.replace("''", "'")
        if "\\" in body or '"' in body:
            raise ValueError(f"{where}: escapes in double-quoted strings are not supported: {s!r}")
        return body
    if s in _NULL:
        return None
    if s in _BOOL:
        return _BOOL[s]
    if _INT.fullmatch(s):
        return int(s)
    if _FLOAT.fullmatch(s):
        return float(s)
    if _REFUSED.fullmatch(s):
        raise ValueError(f"{where}: YAML 1.1 reads {s!r} otherwise than plain Python would;"
                         " write a decimal integer or a float with a dot (1.0e-4)")
    if s[0] in _INDICATORS + "'\"" or ": " in s or s.endswith(":"):
        raise ValueError(f"{where}: {s!r} is outside the supported YAML subset")
    return s


def _flow_items(body: str, where: str) -> list[str]:
    if any(c in body for c in "[]{}"):
        raise ValueError(f"{where}: nested flow collections are not supported")
    if not body.strip():
        return []
    items, cur, quote = [], "", None
    for c in body:
        if quote:
            quote = None if c == quote else quote
        elif c in "'\"":
            quote = c
        elif c == ",":
            items.append(cur)
            cur = ""
            continue
        cur += c
    items.append(cur)
    if any(not it.strip() for it in items):
        raise ValueError(f"{where}: empty item in a flow collection")
    return items


def _value(text: str, where: str):
    s = text.strip()
    if s.startswith("[") or s.startswith("{"):
        close = "]" if s[0] == "[" else "}"
        if not s.endswith(close):
            raise ValueError(f"{where}: a flow collection must close on its own line")
        items = _flow_items(s[1:-1], where)
        if close == "]":
            return [_scalar(it, where) for it in items]
        out = {}
        for it in items:
            key, sep, val = it.strip().partition(": ")
            if not sep or not _KEY.fullmatch(key) or key in out:
                raise ValueError(f"{where}: bad or repeated flow-map entry {it.strip()!r}")
            out[key] = _scalar(val, where)
        return out
    return _scalar(s, where)


def parse_yaml(text: str, name: str = "<yaml>") -> dict:
    """Parse the YAML subset of the repo's configs into a dict; raise a
    ``ValueError`` naming ``name`` and the line on anything outside it."""
    out: dict = {}
    for n, raw in enumerate(text.splitlines(), 1):
        where = f"{name}:{n}"
        line = _strip_comment(raw).rstrip()
        if not line:
            continue
        if "\t" in line or line[0] in " ":
            raise ValueError(f"{where}: indented blocks are not supported: {raw.strip()!r}")
        key, sep, rest = line.partition(":")
        if not sep or not _KEY.fullmatch(key) or (rest and not rest.startswith(" ")):
            raise ValueError(f"{where}: expected 'key: value', got {raw.strip()!r}")
        if key in out:
            raise ValueError(f"{where}: key {key!r} repeated")
        out[key] = _value(rest, where)
    return out


def load_config(path: str, **overrides) -> ExperimentConfig:
    with open(path) as f:
        raw = parse_yaml(f.read(), path)
    es = raw.pop("early_stopping", {}) or {}
    raw.setdefault("es_min_delta", es.get("min_delta", 1e-4))
    raw.setdefault("es_patience", es.get("patience", 50))
    known = {f.name for f in dataclasses.fields(ExperimentConfig)}
    raw = {k: v for k, v in raw.items() if k in known}
    raw.update(overrides)
    return ExperimentConfig(**raw)
