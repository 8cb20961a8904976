"""Code-Pattern DB (paper §3.4 B-1/B-2, §4.1) — the port of
``repro/core/pattern_db.py``.

The paper keeps a MySQL database keyed by library name, holding for each
offloadable function block: the accelerated replacement (GPU library / FPGA IP
core), its code or executable, its *usage recipe* (利用手法), and reference
code used by the similarity detector.  Here the DB is a JSON-persistable
registry whose "executables" are dotted import paths into this package (the
CUDA shelf lives in ``repro_torch.kernels``), so entries survive
serialisation the same way executable paths did in MySQL.  The entries are
the reference's, with implementations in this package and ``cuda`` targets
(``ssd_scan`` resolves to ``repro_torch.kernels.ops.ssd_scan``, the chunked
scan over the SSD chunk kernel).
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import pathlib
from typing import Any, Callable, Iterable, Mapping

from repro_torch.core.interface import InterfaceSpec, Param


def _spec_to_json(spec: InterfaceSpec) -> dict:
    return {
        "params": [dataclasses.asdict(p) for p in spec.params],
        "returns": list(spec.returns),
    }


def _spec_from_json(d: Mapping[str, Any]) -> InterfaceSpec:
    return InterfaceSpec(
        params=tuple(Param(**p) for p in d["params"]),
        returns=tuple(d["returns"]),
    )


@dataclasses.dataclass
class ReplacementEntry:
    """One row of the Code-Pattern DB.

    name           canonical block name ("fft2d", "lu", "matmul", ...)
    source_names   call names this entry replaces (A-1 keys): the "external
                   library list" of the paper.
    impl           dotted path to the accelerated callable
                   (e.g. "repro_torch.kernels.ops:fft2d") — the cuFFT/IP-core
                   slot.
    target         execution target: "cuda" | "torch" | "ref"
    interface      replacement interface (for C-1/C-2 matching)
    reference_code source text registered for similarity detection (B-2);
                   None => this entry is only found via name match (B-1).
    usage_recipe   free-text recipe: how the host program calls the block
                   (the paper registers利用手法 with each executable).
    cost_hint      arithmetic-intensity style hints used by the dry-run
                   pre-filter (the FPGA "narrow before measuring" step).
    """

    name: str
    source_names: tuple[str, ...]
    impl: str
    target: str = "torch"
    interface: InterfaceSpec | None = None
    reference_code: str | None = None
    usage_recipe: str = ""
    cost_hint: dict = dataclasses.field(default_factory=dict)

    def resolve(self) -> Callable[..., Any]:
        """Import and return the replacement callable."""
        mod_name, _, attr = self.impl.partition(":")
        mod = importlib.import_module(mod_name)
        fn: Any = mod
        for part in attr.split("."):
            fn = getattr(fn, part)
        return fn

    def to_json(self) -> dict:
        d = {
            "name": self.name,
            "source_names": list(self.source_names),
            "impl": self.impl,
            "target": self.target,
            "interface": _spec_to_json(self.interface) if self.interface else None,
            "reference_code": self.reference_code,
            "usage_recipe": self.usage_recipe,
            "cost_hint": self.cost_hint,
        }
        return d

    @classmethod
    def from_json(cls, d: Mapping[str, Any]) -> "ReplacementEntry":
        return cls(
            name=d["name"],
            source_names=tuple(d["source_names"]),
            impl=d["impl"],
            target=d.get("target", "torch"),
            interface=_spec_from_json(d["interface"]) if d.get("interface") else None,
            reference_code=d.get("reference_code"),
            usage_recipe=d.get("usage_recipe", ""),
            cost_hint=dict(d.get("cost_hint", {})),
        )


class CodePatternDB:
    """Name-keyed + similarity-searchable registry of replacements."""

    def __init__(self, entries: Iterable[ReplacementEntry] = ()) -> None:
        self._entries: dict[str, ReplacementEntry] = {}
        self._by_source: dict[str, str] = {}
        for e in entries:
            self.register(e)

    # -- registration ------------------------------------------------------
    def register(self, entry: ReplacementEntry) -> None:
        self._entries[entry.name] = entry
        for src in entry.source_names:
            self._by_source[src] = entry.name

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def entries(self) -> list[ReplacementEntry]:
        return list(self._entries.values())

    def get(self, name: str) -> ReplacementEntry:
        return self._entries[name]

    # -- A-1 / B-1: library-name matching ----------------------------------
    @property
    def known_library_names(self) -> set[str]:
        """The external-library list used by Step-1 code analysis."""
        return set(self._by_source)

    def lookup_by_call(self, call_name: str) -> ReplacementEntry | None:
        """B-1: find a replacement for a detected library call."""
        name = self._by_source.get(call_name)
        if name is None:
            # also accept an unqualified trailing component ("np.fft.fft2" ~ "fft2")
            tail = call_name.rsplit(".", 1)[-1]
            name = self._by_source.get(tail)
        return self._entries.get(name) if name else None

    # -- B-2: similarity candidates ----------------------------------------
    def entries_with_reference(self) -> list[ReplacementEntry]:
        return [e for e in self._entries.values() if e.reference_code]

    # -- persistence ---------------------------------------------------------
    def save(self, path: str | pathlib.Path) -> None:
        path = pathlib.Path(path)
        path.write_text(
            json.dumps([e.to_json() for e in self._entries.values()], indent=2)
        )

    @classmethod
    def load(cls, path: str | pathlib.Path) -> "CodePatternDB":
        data = json.loads(pathlib.Path(path).read_text())
        return cls(ReplacementEntry.from_json(d) for d in data)


def default_db() -> CodePatternDB:
    """The stock pattern DB shipped with the framework.

    Mirrors the paper's evaluation setup: FFT and LU entries whose
    replacements are this package's CUDA implementations, plus the block
    shelf used by the model zoo (matmul, attention, rmsnorm, ssd).
    Reference code snippets (for B-2/Deckard matching) are the naive apps.
    """

    from repro_torch.apps import fourier, matrix  # local import to avoid cycles

    f32 = "float32"
    f64 = "float64"
    entries = [
        ReplacementEntry(
            name="fft2d",
            source_names=("fft2d", "fft2d_nr", "np.fft.fft2", "fft2"),
            impl="repro_torch.kernels.ops:fft2d",
            target="cuda",
            interface=InterfaceSpec(
                params=(Param("x", "complex64", rank=2),),
                returns=("complex64",),
            ),
            reference_code=fourier.REFERENCE_CODE,
            usage_recipe=(
                "y = fft2d(x): 2-D complex FFT via matmul-DFT stages (the "
                "complex_matmul CUDA kernel); "
                "x (n,m) complex64, n,m powers of two >= 128 preferred."
            ),
            cost_hint={"flops_per_elem": "5*log2(n*m)", "intensity": "high"},
        ),
        ReplacementEntry(
            name="lu",
            source_names=("ludcmp", "ludcmp_nr", "lu_factor", "scipy.linalg.lu"),
            impl="repro_torch.kernels.ops:lu_nr_compat",
            target="cuda",
            interface=InterfaceSpec(
                params=(Param("a", f32, rank=2),),
                returns=(f32, "int32", f32),
            ),
            reference_code=matrix.REFERENCE_CODE,
            usage_recipe=(
                "lu, indx, d = lu_nr_compat(a): blocked right-looking LU with "
                "partial pivoting (NR-shaped interface); trailing updates hit "
                "the schur_update CUDA kernel.  Pads internally to nb."
            ),
            cost_hint={"flops": "2/3*n^3", "intensity": "n/3"},
        ),
        ReplacementEntry(
            name="matmul",
            source_names=("matmul", "np.matmul", "np.dot", "matmul_nr"),
            impl="repro_torch.kernels.ops:matmul",
            target="cuda",
            interface=InterfaceSpec(
                params=(
                    Param("a", f32, rank=2, align=128),
                    Param("b", f32, rank=2, align=128),
                ),
                returns=(f32,),
            ),
            usage_recipe="c = matmul(a, b): tiled f32 CUDA matmul.",
            cost_hint={"flops": "2*m*n*k", "intensity": "min(m,n,k)/2"},
        ),
        ReplacementEntry(
            name="attention",
            source_names=("attention", "scaled_dot_product_attention", "sdpa"),
            impl="repro_torch.kernels.attention:flash_attention",
            target="cuda",
            usage_recipe=(
                "o = flash_attention(q, k, v, causal=True): online-softmax "
                "fused attention, tiled over kv blocks."
            ),
            cost_hint={"flops": "4*b*h*s^2*d", "intensity": "s/2"},
        ),
        ReplacementEntry(
            name="rmsnorm",
            source_names=("rmsnorm", "rms_norm"),
            impl="repro_torch.kernels.rmsnorm:rmsnorm",
            target="cuda",
            usage_recipe="y = rmsnorm(x, w, eps): fused mean-square + scale.",
            cost_hint={"intensity": "low"},
        ),
        ReplacementEntry(
            name="ssd_scan",
            source_names=("ssd_scan", "mamba_chunk_scan", "selective_scan"),
            impl="repro_torch.kernels.ops:ssd_scan",
            target="cuda",
            usage_recipe=(
                "y, final_state = ssd_scan(x, dt, A, B, C, chunk): Mamba-2 "
                "state-space-duality chunked scan (intra-chunk matmul + "
                "inter-chunk recurrence)."
            ),
            cost_hint={"intensity": "chunk/2"},
        ),
    ]
    return CodePatternDB(entries)
