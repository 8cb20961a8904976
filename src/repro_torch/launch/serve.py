"""Serving CLI — a thin command line over :class:`repro_torch.serve.ServeEngine`
(the port of ``repro/launch/serve.py``).

Submits a mixed-length batch of random-token requests, drives the engine
until idle and prints throughput and latency.  Runs on the CUDA card:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
      --page-size 16 --slots 8 --max-len 1024

``--device cpu`` runs on the CPU explicitly (the tests do, with
``--reduced``).  ``--layers N`` keeps the first N layers of the pattern at
full width, a depth cut for models whose weights pass one card's memory
(deepseek-v2-236b at 4 layers, ``daaa``; arctic-480b at 1).  ``--plan-dir`` binds each phase to its stored
``zoo:<arch>:prefill`` / ``:decode`` plan (``--plan-search`` searches and
commits the missing ones first, over ``--plan-targets``), ``--plan-key``
names one plan for both phases, and ``--decode-impl`` pins decode's
``paged_attention`` target.  ``--prefill-chunk`` splits long prompts into
chunks run between decode steps; ``--trace-out`` writes a Chrome/Perfetto trace of the
request lifecycles (inspect with ``python -m repro_torch.obs.timeline``)
and ``--metrics-out`` a Prometheus text snapshot of the engine's metrics.
``--meter`` adds power telemetry (J/token per phase, with its
measured/estimated provenance): ``nvml`` reads the card's board draw
through NVIDIA's NVML library, ``auto`` takes the best meter the host
has.  ``--kv-validate`` re-checks the page table after every mutation
(``repro_torch.analysis.paging``).  ``--preflight`` sizes the deployment
against ``--envelope`` from metadata and exits without building the
engine: 0 when it fits, 2 when it does not.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from repro_torch.configs import get_config
from repro_torch.metering import EXECUTOR_NAMES, METER_NAMES
from repro_torch.obs import Tracer
from repro_torch.serve import Request, Sampler, ServeEngine


def percentile(xs: "list[float]", q: float) -> float:
    """Empty-safe quantile of a sample."""
    if not xs:
        return float("nan")
    return float(np.percentile(xs, q * 100))


def format_kv_metrics(engine: ServeEngine) -> str:
    """One line of KV-memory health from ``engine.metrics()``.
    Stranded/utilization/fragmentation are means of one sample per engine
    step while requests were resident."""
    m = engine.metrics()
    kv = m["kv"]
    if m["mode"] == "paged":
        return (
            f"kv pool: {kv['n_pages']} x {kv['page_size']}-token pages, "
            f"peak {kv['peak_used_pages']} used "
            f"({100.0 * kv['peak_used_pages'] / kv['n_pages']:.0f}% peak, "
            f"{m['mean_utilization_pct']:.1f}% mean utilization), "
            f"stranded {m['mean_stranded_pct']:.1f}%, "
            f"fragmentation {m['mean_fragmentation_pct']:.1f}%, "
            f"{m['preemptions']} preemptions, "
            f"{m['prefill_chunks']} prefill chunks"
        )
    return (
        f"kv cache: contiguous {m['n_slots']} x {m['max_len']} "
        f"({kv['token_capacity']} tokens reserved worst-case), "
        f"{m['mean_utilization_pct']:.1f}% mean slot utilization, "
        f"stranded {m['mean_stranded_pct']:.1f}% of reserved, "
        f"{m['prefill_chunks']} prefill chunks"
    )


def write_obs_outputs(engine: ServeEngine, args: argparse.Namespace) -> None:
    """Write the observability outputs the CLI asked for: a Chrome/Perfetto
    trace (``--trace-out``) and a Prometheus text snapshot of the engine's
    registry (``--metrics-out``)."""
    if args.trace_out:
        engine.tracer.write_chrome(args.trace_out)
        print(f"trace written: {args.trace_out} "
              f"({len(engine.tracer)} records; inspect with "
              f"python -m repro_torch.obs.timeline {args.trace_out})")
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            f.write(engine.registry.render_prometheus())
        print(f"metrics written: {args.metrics_out}")


def make_requests(cfg, args: argparse.Namespace, rng: np.random.Generator) -> list[Request]:
    """Mixed-length random-token trace: prompt and generation lengths jitter
    uniformly around the base values so slots stagger and free at
    different steps."""
    requests = []
    for _ in range(args.requests):
        plen = max(1, args.prompt_len + int(rng.integers(-args.len_jitter, args.len_jitter + 1)))
        gen = max(1, args.gen + int(rng.integers(-args.gen_jitter, args.gen_jitter + 1)))
        prompt = rng.integers(0, cfg.vocab_size, plen).tolist()
        requests.append(Request(prompt, max_new_tokens=gen))
    return requests


def add_engine_args(ap: argparse.ArgumentParser) -> None:
    """The flags that shape the engine (:func:`build_engine` reads them),
    shared by this CLI and any script that builds its engine the same way."""
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="keep the first N layers (a depth cut; widths stay)")
    ap.add_argument("--slots", type=int, default=4, help="KV slots = max concurrent requests")
    ap.add_argument("--max-len", type=int, default=256,
                    help="cache positions per slot (prompt + generation)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sampler", default="greedy",
                    help="default sampling policy: greedy | temperature:<t> | top_k:<k>[:<t>]")
    ap.add_argument("--step-budget", type=int, default=None,
                    help="max tokens (prefill + decode) one engine step may process")
    ap.add_argument("--prefill-bucket", type=int, default=None,
                    help="pad prompts to a multiple of this bucket")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="split prompts longer than this into chunk-sized prefill "
                         "pieces interleaved with decode steps (attention-family archs)")
    ap.add_argument("--page-size", type=int, default=None,
                    help="block-paged KV cache: tokens per page (default: contiguous slots)")
    ap.add_argument("--n-pages", type=int, default=None,
                    help="KV pool size in pages (default: capacity-equivalent, "
                         "slots * ceil(max_len/page_size); smaller over-commits)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--decode-impl", default="auto", choices=("auto", "torch", "cuda"),
                    help="pin the paged_attention binding for the decode hot loop "
                         "(requires --page-size): torch = page gather + dense softmax, "
                         "cuda = the paged attention kernel; auto defers to the stored "
                         "decode plan / the device's default")
    ap.add_argument("--plan-dir", default=None,
                    help="PlanStore directory with verified offload plans")
    ap.add_argument("--plan-key", default=None,
                    help="explicit plan key bound to BOTH phases; default is the "
                         "stored zoo:<arch>:prefill / :decode plans")
    ap.add_argument("--plan-search", action="store_true",
                    help="search+commit missing zoo plans for this arch before "
                         "binding (the verification-environment step)")
    ap.add_argument("--plan-targets", default=None,
                    help="targets --plan-search searches over (default: torch,cuda "
                         "on the card, ref,torch with --device cpu)")
    ap.add_argument("--executor", default="serial", choices=EXECUTOR_NAMES,
                    help="measurement executor for --plan-search")
    ap.add_argument("--meter", default="none", choices=METER_NAMES,
                    help="power telemetry per phase (and for --plan-search's trials)")
    ap.add_argument("--trace-out", default=None,
                    help="enable request-lifecycle tracing and write a Chrome/Perfetto "
                         "trace_event JSON here")
    ap.add_argument("--metrics-out", default=None,
                    help="write a Prometheus text snapshot of the engine's metrics here")
    ap.add_argument("--kv-validate", action="store_true",
                    help="run the repro_torch.analysis page-aliasing sanitizer after "
                         "every page-table mutation (debug mode; raises on aliasing or "
                         "accounting drift)")
    ap.add_argument("--envelope", default=None,
                    help="device envelope for --preflight: a static name (h100-80g, "
                         "cpu-host-16g, tiny-32m, ...) or 'host' to probe --device "
                         "(default)")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_engine_args(ap)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--len-jitter", type=int, default=8,
                    help="uniform prompt-length jitter (staggers slots)")
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--gen-jitter", type=int, default=4)
    ap.add_argument("--max-steps", type=int, default=10_000)
    ap.add_argument("--preflight", action="store_true",
                    help="static capacity check only: size params + KV against "
                         "--envelope and exit (0 fits, 2 not) without building the engine")
    return ap


def config_of(args: argparse.Namespace):
    """The config the flags name: ``--arch``, ``--reduced``, ``--layers``."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers:
        cfg = cfg.cut(args.layers)
    return cfg


def preflight(args: argparse.Namespace, cfg=None) -> int:
    """Static capacity check of the requested deployment — the paper's
    FPGA resource-fit gate applied before the engine is built.  Sizes
    params + KV cache from metadata (nothing is materialised, so full-size
    configs check in milliseconds) against ``--envelope`` and refuses to
    proceed when they cannot fit.  ``cfg`` defaults to the flags' config
    (:func:`config_of`).  Returns a process exit code: 0 fits, 2 does
    not."""
    from repro_torch.analysis.resources import plan_serve_capacity

    cfg = config_of(args) if cfg is None else cfg
    plan = plan_serve_capacity(
        cfg,
        n_slots=args.slots,
        max_len=args.max_len,
        page_size=args.page_size,
        n_pages=args.n_pages,
        envelope=args.envelope,
        device=args.device,
    )
    print(plan.summary())
    if (
        args.prefill_chunk
        and plan.max_prefill_tokens is not None
        and args.prefill_chunk > plan.max_prefill_tokens
    ):
        print(
            f"preflight: note --prefill-chunk {args.prefill_chunk} exceeds "
            f"the activation-headroom bound ({plan.max_prefill_tokens})",
            file=sys.stderr,
        )
    if not plan.fits:
        print(
            f"preflight: FAIL — {plan.arch} with {plan.n_slots} slots x "
            f"{plan.max_len} tokens does not fit {plan.envelope.name}",
            file=sys.stderr,
        )
        return 2
    print("preflight: OK")
    return 0


def plan_keys_of(args: argparse.Namespace) -> "dict[str, str | None] | str | None":
    """The engine's ``plan_keys`` from the CLI: ``--plan-key`` for both
    phases, or (with ``--plan-search``) each phase's zoo key after the
    missing plans are searched and committed; None leaves the engine to
    find the stored zoo plans in ``--plan-dir``."""
    if args.plan_key:
        return args.plan_key
    if args.plan_dir and args.plan_search:
        from repro_torch.offload.zoo import DEFAULT_TARGETS, launch_plan_keys

        targets = (tuple(args.plan_targets.split(",")) if args.plan_targets
                   else DEFAULT_TARGETS[args.device])
        return launch_plan_keys(
            args.plan_dir, args.arch, ("prefill", "decode"), search=True,
            targets=targets, executor=args.executor, meter=args.meter,
            device=args.device,
        )
    return None


def build_engine(args: argparse.Namespace) -> ServeEngine:
    """The engine :func:`add_engine_args`' flags describe (the reference's
    engine construction, shared with its load benchmark)."""
    return ServeEngine(
        config_of(args),
        n_slots=args.slots,
        max_len=args.max_len,
        sampler=Sampler.parse(args.sampler),
        max_tokens_per_step=args.step_budget,
        prefill_bucket=args.prefill_bucket,
        prefill_chunk=args.prefill_chunk,
        page_size=args.page_size,
        n_pages=args.n_pages,
        seed=args.seed,
        device=args.device,
        plan_dir=args.plan_dir,
        plan_keys=plan_keys_of(args),
        decode_impl=args.decode_impl,
        meter=args.meter,
        kv_validate=args.kv_validate,
        quiet=False,
        # --trace-out turns tracing on for this engine; without it the
        # engine keeps the process tracer, disabled
        tracer=Tracer() if args.trace_out else None,
    )


def main(argv: "list[str] | None" = None) -> int:
    args = build_parser().parse_args(argv)
    if args.preflight:
        return preflight(args)
    engine = build_engine(args)
    rng = np.random.default_rng(args.seed)
    requests = make_requests(engine.cfg, args, rng)
    for request in requests:
        engine.submit(request)
    completions = engine.run_until_idle(max_steps=args.max_steps)

    stats = engine.stats
    if stats.requests_completed != len(requests):
        raise RuntimeError(f"{stats.requests_completed}/{len(requests)} requests completed")
    print(f"arch={engine.cfg.name} slots={args.slots} requests={len(requests)} "
          f"device={engine.device}")
    for phase in ("prefill", "decode"):
        print(engine.telemetry[phase].summary())
    latencies = [c.latency for c in completions]
    ttfts = [c.ttft for c in completions]
    print(
        f"latency: p50 {percentile(latencies, 0.5)*1e3:.1f} ms "
        f"p99 {percentile(latencies, 0.99)*1e3:.1f} ms | "
        f"ttft: p50 {percentile(ttfts, 0.5)*1e3:.1f} ms "
        f"p99 {percentile(ttfts, 0.99)*1e3:.1f} ms"
    )
    ttfts_admitted = [c.ttft_admitted for c in completions]
    queue_waits = [c.queue_wait for c in completions]
    print(
        f"ttft from admit: p50 {percentile(ttfts_admitted, 0.5)*1e3:.1f} ms "
        f"p99 {percentile(ttfts_admitted, 0.99)*1e3:.1f} ms | "
        f"queue wait: p50 {percentile(queue_waits, 0.5)*1e3:.1f} ms "
        f"p99 {percentile(queue_waits, 0.99)*1e3:.1f} ms"
    )
    print(
        f"continuous batching: {stats.slot_reuses} slot reuses, "
        f"max {stats.max_active} concurrent, {stats.steps} engine steps, "
        f"decode median {engine.median_decode_step()*1e3:.2f} ms/step"
    )
    print(format_kv_metrics(engine))
    graphs = engine.graph_stats()
    print("step programs: " + " | ".join(
        f"{name} {g['eager_calls']} eager, {g['captures']} captured "
        f"({g['capture_seconds']:.2f}s), {g['replays']} replayed" for name, g in graphs.items()
    ))
    sample = completions[0]
    print(f"sample (request {sample.request_id}):", np.asarray(sample.tokens[:16]))
    write_obs_outputs(engine, args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
