"""Call-site substitution (paper §3.4 C-1/C-2, §4.2 implementation step).
A copy of ``repro/core/substitute.py``: pure Python, nothing to port.

The paper's implementation deletes the original library call / copied code
from the C source and writes the replacement invocation in its place, then
compiles (PGI for GPU, Intel HLS for FPGA).  For Python applications the
analogue is an AST rewrite + recompile:

* ``rewrite_calls`` — replaces ``Call`` nodes whose (dotted) target matches a
  mapping key with a call to an injected replacement binding, recompiles the
  module AST and returns the new namespace.  This handles A-1 hits, including
  attribute calls like ``np.fft.fft2`` that cannot be shadowed.
* ``shadow_functions`` — for A-2 hits (a *local* def judged similar to DB
  reference code): rebinds the module-level name to the adapted replacement,
  which is exactly "delete the original definition and use the accelerated
  block instead".

Both return plain callables, so the verification environment can measure
original vs substituted variants side by side.
"""

from __future__ import annotations

import ast
import textwrap
from typing import Any, Callable, Mapping

_REPL_PREFIX = "__repro_offload_"


class _CallRewriter(ast.NodeTransformer):
    def __init__(self, mapping: Mapping[str, str]) -> None:
        # mapping: dotted source call name -> replacement binding name
        self.mapping = dict(mapping)
        self.tails = {k.rsplit(".", 1)[-1]: v for k, v in mapping.items()}
        self.rewritten: list[str] = []

    def visit_Call(self, node: ast.Call) -> ast.AST:
        self.generic_visit(node)
        name = _dotted(node.func)
        if name is None:
            return node
        target = self.mapping.get(name) or self.tails.get(name.rsplit(".", 1)[-1])
        if target is None:
            return node
        self.rewritten.append(name)
        new = ast.Call(
            func=ast.Name(id=target, ctx=ast.Load()),
            args=node.args,
            keywords=node.keywords,
        )
        return ast.copy_location(new, node)


def _dotted(node: ast.AST) -> str | None:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _dotted(node.value)
        return f"{base}.{node.attr}" if base else None
    return None


def rewrite_calls(
    source: str,
    replacements: Mapping[str, Callable[..., Any]],
    globalns: dict[str, Any] | None = None,
) -> dict[str, Any]:
    """Rewrite matching call sites in ``source`` and execute the result.

    ``replacements`` maps the *source call name* (as written, or its tail) to
    the adapted replacement callable.  Returns the executed namespace, which
    contains the rewritten functions plus ``__offload_rewritten__`` — the list
    of call names actually replaced.
    """

    source = textwrap.dedent(source)
    tree = ast.parse(source)
    binding_names = {
        name: f"{_REPL_PREFIX}{i}" for i, name in enumerate(replacements)
    }
    rewriter = _CallRewriter(binding_names)
    new_tree = rewriter.visit(tree)
    ast.fix_missing_locations(new_tree)
    code = compile(new_tree, filename="<repro-offload>", mode="exec")
    ns: dict[str, Any] = dict(globalns or {})
    for name, binding in binding_names.items():
        ns[binding] = replacements[name]
    exec(code, ns)
    ns["__offload_rewritten__"] = list(rewriter.rewritten)
    return ns


def shadow_functions(
    namespace: dict[str, Any], replacements: Mapping[str, Callable[..., Any]]
) -> dict[str, Any]:
    """A-2 substitution: rebind local definition names to replacements."""
    ns = dict(namespace)
    for name, fn in replacements.items():
        ns[name] = fn
    return ns


def extract_function(ns: Mapping[str, Any], name: str) -> Callable[..., Any]:
    fn = ns[name]
    if not callable(fn):
        raise TypeError(f"{name} is not callable after substitution")
    return fn
