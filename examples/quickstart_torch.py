"""Quickstart on the card: the paper's pipeline as one OffloadSession of the
PyTorch / CUDA port (``repro_torch``), the counterpart of
``examples/quickstart.py``.

1. Take a CPU application (naive Numerical-Recipes 2-D FFT).
2. Run the lifecycle stage by stage: analyze the source, discover the
   offloadable function block via the Code-Pattern DB, search offload
   patterns by measurement, verify numerics, commit the winner.
3. Compare with the prior-work GA loop offloader (paper Fig. 4/5).

  PYTHONPATH=src python examples/quickstart_torch.py [--fast] [--device cpu]
"""

import argparse
import functools
import sys
import warnings

warnings.filterwarnings("ignore")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true", help="smaller input")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    n = 64 if args.fast else 192

    from repro_torch.apps import fourier
    from repro_torch.core import run_ga
    from repro_torch.offload import OffloadSession

    x = fourier.make_input(n)

    print(f"=== function-block offload (the paper) — {n}x{n} 2-D FFT ===")
    session = OffloadSession(fourier.fourier_app_libcall, args=(x,), repeats=1,
                             device=args.device)
    session.analyze()
    for d in session.discover():
        print(f"  discovered: {d.source_name} -> {d.entry.name} "
              f"({d.kind}, target {d.entry.target})")
    session.plan()
    session.verify()
    res = session.commit()
    for t in res.trials:
        print(f"  trial {t.pattern or '(baseline)'}: {t.seconds*1e3:.1f} ms "
              f"({t.speedup:.1f}x)")
    print(f"  best offload pattern: {res.pattern} "
          f"speedup {res.speedup:.1f}x, "
          f"numerics verified: {res.numerics_ok}, "
          f"search took {res.report.search_seconds:.1f}s")

    print("=== prior-work loop offload (GA) on the same app ===")
    ga = run_ga(
        functools.partial(fourier.build_fft_variant, device=args.device),
        n_genes=len(fourier.FFT_STAGES),
        args=(x,), population=6, generations=3 if args.fast else 5,
        repeats=1, seed=0,
    )
    print(f"  GA best genome {ga.best_genome}: {ga.best_speedup:.1f}x "
          f"after {ga.evaluations} measured trials "
          f"({ga.search_seconds:.1f}s search)")

    ratio = ga.best_seconds / res.best_seconds
    print(f"=== function-block offload is {ratio:.1f}x faster than the best "
          f"loop-offload pattern (paper Fig. 5, in kind) ===")
    return 0


if __name__ == "__main__":
    sys.exit(main())
