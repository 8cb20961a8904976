"""Offloading an *existing* application you didn't write for acceleration,
with the PyTorch / CUDA port (``repro_torch``): the counterpart of
``examples/offload_existing_app.py``.

Demonstrates all three discovery/adaptation paths of the paper:
  A-1/B-1  a named library call (ludcmp) found by DB name matching;
  A-2/B-2  a copied-and-modified block (my_ludcmp) found by Deckard-style
           similarity;
  C-2      an interface mismatch that needs the user's confirmation before
           substitution (here: a replacement returning fewer values).

  PYTHONPATH=src python examples/offload_existing_app_torch.py [--device cpu]
"""

import argparse
import sys
import warnings

warnings.filterwarnings("ignore")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    from repro_torch.apps import matrix
    from repro_torch.core import Policy
    from repro_torch.core.interface import InterfaceSpec, Param, match_interfaces
    from repro_torch.offload import OffloadSession

    a = matrix.make_input(128)

    print("=== A-1/B-1: library call found by name ===")
    res = OffloadSession(matrix.matrix_app_libcall, args=(a,), repeats=1,
                         device=args.device).run()
    d = res.discoveries[0]
    print(f"  {d.source_name} -> {d.entry.name} via {d.kind}")
    print(f"  recipe: {d.entry.usage_recipe[:70]}...")
    print(f"  speedup {res.speedup:.1f}x, "
          f"numerics ok: {res.numerics_ok}")

    print("=== A-2/B-2: copied code found by similarity ===")
    res2 = OffloadSession(matrix.matrix_app_copied, args=(a,), repeats=1,
                          device=args.device).run()
    d2 = res2.discoveries[0]
    print(f"  {d2.source_name} -> {d2.entry.name} via {d2.kind} "
          f"(score {d2.score:.2f})")
    print(f"  speedup {res2.speedup:.1f}x")

    print("=== C-2: interface mismatch requires confirmation ===")
    src = InterfaceSpec(
        params=(Param("a", "float64", rank=2), Param("b", "float64", rank=1)),
        returns=("float64", "int64", "float64"),
    )
    dst = InterfaceSpec(
        params=(Param("a", "float32", rank=2),),
        returns=("float32", "int32"),
    )
    try:
        match_interfaces(src, dst)  # default policy: deny
        print("  unexpected: adaptation proceeded without the user")
    except Exception as e:
        print(f"  blocked as expected: {e}")
    asked = []
    pol = Policy(confirm=lambda msg: asked.append(msg) or True)
    adaptation = match_interfaces(src, dst, pol)
    print(f"  after user confirmation ({len(asked)} questions): "
          f"dropped={adaptation.dropped}, casts applied")
    return 0 if res.numerics_ok and res2.numerics_ok else 1


if __name__ == "__main__":
    sys.exit(main())
