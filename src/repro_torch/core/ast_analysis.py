"""Step-1 code analysis (paper §3.4 A-1/A-2) — the Clang/libClang analogue.
A copy of ``repro/core/ast_analysis.py``: pure Python, nothing to port.

The paper parses C/C++ with libClang to find (i) loop statements and their
trip structure for the prior loop-offload method, (ii) calls to external
libraries (A-1, matched against the DB's library list), and (iii) locally
defined classes/structs that may be copied-and-modified library code (A-2,
handed to the similarity detector).

Here the applications are Python/NumPy programs, so the direct analogue is
the stdlib ``ast`` module.  The report structure mirrors the paper's Step-1
output.
"""

from __future__ import annotations

import ast
import dataclasses
import inspect
import textwrap
from typing import Any, Callable, Iterable


@dataclasses.dataclass(frozen=True)
class CallSite:
    """A call to a known external library (A-1 hit)."""

    call_name: str  # dotted name as written, e.g. "np.fft.fft2"
    lineno: int
    enclosing: str  # enclosing function name ("<module>" at top level)


@dataclasses.dataclass(frozen=True)
class FuncDef:
    """A locally defined function/class (A-2 candidate)."""

    name: str
    lineno: int
    source: str  # source segment of the definition
    kind: str  # "function" | "class"
    calls: tuple[str, ...]  # dotted call names inside the def


@dataclasses.dataclass(frozen=True)
class LoopSite:
    """A loop statement (input to the prior-work loop offloader / GA)."""

    loop_id: int
    lineno: int
    enclosing: str
    kind: str  # "for" | "while"
    depth: int  # nesting depth, 0 = outermost
    body_len: int  # number of statements — crude arithmetic-intensity proxy


@dataclasses.dataclass
class SourceReport:
    """Everything Step 1 learned about one source unit."""

    library_calls: list[CallSite]
    func_defs: list[FuncDef]
    loops: list[LoopSite]
    source: str

    def calls_to(self, names: Iterable[str]) -> list[CallSite]:
        names = set(names)
        out = []
        for c in self.library_calls:
            if c.call_name in names or c.call_name.rsplit(".", 1)[-1] in names:
                out.append(c)
        return out


def _dotted_name(node: ast.AST) -> str | None:
    """Render ``a.b.c`` call targets; None for computed targets."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _dotted_name(node.value)
        return f"{base}.{node.attr}" if base else None
    return None


class _Analyzer(ast.NodeVisitor):
    def __init__(self, source: str, known_libraries: set[str]) -> None:
        self.source = source
        self.known = known_libraries
        self.known_tails = {k.rsplit(".", 1)[-1] for k in known_libraries}
        self.calls: list[CallSite] = []
        self.defs: list[FuncDef] = []
        self.loops: list[LoopSite] = []
        self._stack: list[str] = ["<module>"]
        self._loop_depth = 0
        self._loop_counter = 0

    # -- function / class definitions (A-2 candidates) ---------------------
    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._record_def(node, "function")

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        self._record_def(node, "function")

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._record_def(node, "class")

    def _record_def(self, node: Any, kind: str) -> None:
        inner_calls: list[str] = []
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                nm = _dotted_name(sub.func)
                if nm:
                    inner_calls.append(nm)
        try:
            seg = ast.get_source_segment(self.source, node) or ""
        except Exception:  # pragma: no cover - malformed coordinates
            seg = ""
        self.defs.append(
            FuncDef(
                name=node.name,
                lineno=node.lineno,
                source=seg,
                kind=kind,
                calls=tuple(inner_calls),
            )
        )
        self._stack.append(node.name)
        self.generic_visit(node)
        self._stack.pop()

    # -- library calls (A-1) -------------------------------------------------
    def visit_Call(self, node: ast.Call) -> None:
        nm = _dotted_name(node.func)
        if nm is not None:
            tail = nm.rsplit(".", 1)[-1]
            if nm in self.known or tail in self.known_tails:
                self.calls.append(
                    CallSite(
                        call_name=nm,
                        lineno=node.lineno,
                        enclosing=self._stack[-1],
                    )
                )
        self.generic_visit(node)

    # -- loops (prior-work loop offloading input) ---------------------------
    def visit_For(self, node: ast.For) -> None:
        self._record_loop(node, "for")

    def visit_While(self, node: ast.While) -> None:
        self._record_loop(node, "while")

    def _record_loop(self, node: Any, kind: str) -> None:
        self.loops.append(
            LoopSite(
                loop_id=self._loop_counter,
                lineno=node.lineno,
                enclosing=self._stack[-1],
                kind=kind,
                depth=self._loop_depth,
                body_len=len(node.body),
            )
        )
        self._loop_counter += 1
        self._loop_depth += 1
        self.generic_visit(node)
        self._loop_depth -= 1


def analyze_source(source: str, known_libraries: set[str]) -> SourceReport:
    """Run Step-1 analysis over a source string."""
    source = textwrap.dedent(source)
    tree = ast.parse(source)
    az = _Analyzer(source, known_libraries)
    az.visit(tree)
    return SourceReport(
        library_calls=az.calls, func_defs=az.defs, loops=az.loops, source=source
    )


def analyze_callable(fn: Callable[..., Any], known_libraries: set[str]) -> SourceReport:
    """Step-1 analysis for a live Python callable (reads its source)."""
    return analyze_source(inspect.getsource(fn), known_libraries)


def analyze_module_of(fn: Callable[..., Any], known_libraries: set[str]) -> SourceReport:
    """Step-1 analysis over the whole module defining ``fn`` — matches the
    paper, which analyses the full application source, not one function."""
    mod = inspect.getmodule(fn)
    return analyze_source(inspect.getsource(mod), known_libraries)
