"""Similarity detection (paper §3.4 B-2) — the Deckard analogue.
A copy of ``repro/core/similarity.py``: pure Python, nothing to port.

Deckard [Jiang et al., ICSE'07] detects code clones by mapping every AST
subtree to a *characteristic vector* — occurrence counts of node kinds in the
subtree (with small subtrees merged upward) — then clustering vectors by
Euclidean distance with a size-sensitive threshold.  The paper runs Deckard
between application functions (A-2 candidates) and the reference code stored
in the pattern DB, and treats above-threshold pairs as "this local function is
a copied/modified version of a known offloadable block".

This module implements the same algorithm over Python ASTs:

* ``char_vector(code)`` — counts of a fixed vocabulary of AST node kinds,
  augmented with loop-nest-depth buckets (Deckard's q-level vectors).
* ``similarity(a, b)``  — 1 - ||va - vb||_1 / (||va||_1 + ||vb||_1), a
  size-normalised distance in [0, 1]; 1.0 = identical vectors.  This is the
  "1 - normalised distance" form of Deckard's clustering criterion.

As in the paper, *newly written independent code* will not pass the threshold
— only copies and light modifications (renames, comments, constant tweaks,
small edits) will.  The default threshold (0.85) is calibrated by the tests
against exactly that scenario.
"""

from __future__ import annotations

import ast
import dataclasses
import math
import textwrap
from typing import Iterable

# The node-kind vocabulary.  Deckard uses "relevant" parse-tree nodes; we use
# the structural Python AST kinds, skipping trivia (Load/Store ctx etc.).
_VOCAB = (
    "FunctionDef", "arguments", "arg", "Return",
    "Assign", "AugAssign", "AnnAssign",
    "For", "While", "If", "Break", "Continue",
    "BoolOp", "BinOp", "UnaryOp", "Compare", "Call", "IfExp",
    "Attribute", "Subscript", "Name", "Constant", "Tuple", "List", "Slice",
    "Add", "Sub", "Mult", "Div", "FloorDiv", "Mod", "Pow",
    "BitXor", "BitAnd", "BitOr", "LShift", "RShift",
    "Lt", "Gt", "LtE", "GtE", "Eq", "NotEq", "USub",
    "Lambda", "ListComp", "Dict", "Starred", "keyword",
)
_INDEX = {k: i for i, k in enumerate(_VOCAB)}
_DEPTH_BUCKETS = 4  # loop-nest depth histogram appended to the vector


@dataclasses.dataclass(frozen=True)
class CharVector:
    """Deckard characteristic vector for one code fragment."""

    counts: tuple[int, ...]

    @property
    def size(self) -> int:
        return sum(self.counts)

    def l1(self) -> int:
        return sum(self.counts)

    def distance(self, other: "CharVector") -> float:
        return sum(abs(a - b) for a, b in zip(self.counts, other.counts))


def _iter_nodes(tree: ast.AST) -> Iterable[tuple[ast.AST, int]]:
    """Yield (node, loop_depth) pairs."""
    stack: list[tuple[ast.AST, int]] = [(tree, 0)]
    while stack:
        node, depth = stack.pop()
        yield node, depth
        bump = 1 if isinstance(node, (ast.For, ast.While)) else 0
        for child in ast.iter_child_nodes(node):
            stack.append((child, depth + bump))


def char_vector(code: str | ast.AST) -> CharVector:
    if isinstance(code, str):
        tree = ast.parse(textwrap.dedent(code))
    else:
        tree = code
    counts = [0] * (len(_VOCAB) + _DEPTH_BUCKETS)
    for node, depth in _iter_nodes(tree):
        kind = type(node).__name__
        idx = _INDEX.get(kind)
        if idx is not None:
            counts[idx] += 1
        if isinstance(node, (ast.For, ast.While)):
            counts[len(_VOCAB) + min(depth, _DEPTH_BUCKETS - 1)] += 1
        # operators live one level down in BinOp/Compare nodes
        if isinstance(node, ast.BinOp):
            op_idx = _INDEX.get(type(node.op).__name__)
            if op_idx is not None:
                counts[op_idx] += 1
        if isinstance(node, ast.UnaryOp):
            op_idx = _INDEX.get(type(node.op).__name__)
            if op_idx is not None:
                counts[op_idx] += 1
        if isinstance(node, ast.Compare):
            for op in node.ops:
                op_idx = _INDEX.get(type(op).__name__)
                if op_idx is not None:
                    counts[op_idx] += 1
    return CharVector(counts=tuple(counts))


def similarity(code_a: str | CharVector, code_b: str | CharVector) -> float:
    """Size-normalised similarity in [0, 1]."""
    va = code_a if isinstance(code_a, CharVector) else char_vector(code_a)
    vb = code_b if isinstance(code_b, CharVector) else char_vector(code_b)
    denom = va.l1() + vb.l1()
    if denom == 0:
        return 1.0
    return 1.0 - va.distance(vb) / denom


def cosine(code_a: str | CharVector, code_b: str | CharVector) -> float:
    """Cosine similarity variant (used as a secondary gate)."""
    va = code_a if isinstance(code_a, CharVector) else char_vector(code_a)
    vb = code_b if isinstance(code_b, CharVector) else char_vector(code_b)
    dot = sum(a * b for a, b in zip(va.counts, vb.counts))
    na = math.sqrt(sum(a * a for a in va.counts))
    nb = math.sqrt(sum(b * b for b in vb.counts))
    if na == 0 or nb == 0:
        return 1.0 if na == nb else 0.0
    return dot / (na * nb)


DEFAULT_THRESHOLD = 0.85


@dataclasses.dataclass(frozen=True)
class SimilarityHit:
    """An above-threshold match between local code and a DB reference."""

    local_name: str
    db_name: str
    score: float


def find_similar(
    func_defs,  # Iterable[ast_analysis.FuncDef]
    db_entries,  # Iterable[pattern_db.ReplacementEntry] with reference_code
    threshold: float = DEFAULT_THRESHOLD,
) -> list[SimilarityHit]:
    """B-2: match local function definitions against DB reference code."""
    hits: list[SimilarityHit] = []
    refs = [(e, char_vector(e.reference_code)) for e in db_entries if e.reference_code]
    for fd in func_defs:
        if not fd.source:
            continue
        try:
            v = char_vector(fd.source)
        except SyntaxError:  # pragma: no cover
            continue
        best: SimilarityHit | None = None
        for entry, ref_v in refs:
            s = similarity(v, ref_v)
            # secondary cosine gate guards against size-coincidence matches
            if s >= threshold and cosine(v, ref_v) >= threshold:
                if best is None or s > best.score:
                    best = SimilarityHit(fd.name, entry.name, s)
        if best is not None:
            hits.append(best)
    return hits
