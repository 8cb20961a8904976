"""The port's public surface against the reference's, read from the source
with ``ast`` (the surface tests import neither package).

Every module of ``src/repro/`` has its counterpart in ``src/repro_torch/``
(at the same path, or renamed: ``RENAMED``), and every public top-level
name of a reference module (a def, a class or an assignment not starting
with ``_``) is defined or imported at the top level of its counterpart.
The exceptions are ``ABSENT``, each with its reason, and each must still be
absent from the port (and present in the reference): an exception that is
no longer needed fails here.  Then the reference launcher's engine
construction: one argv builds an engine on each side
(``add_engine_args`` / ``build_engine``) whose f32 greedy traces are
token-identical, and ``preflight`` takes the reference's one argument.
"""

import argparse
import ast
import dataclasses
import pathlib

import jax
import numpy as np
import pytest

from repro.configs import get_config as jget
from repro.launch import serve as jserve
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.launch import serve as tserve

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
REF, PORT = SRC / "repro", SRC / "repro_torch"

#: reference module -> the port's module of another name
RENAMED = {
    "core/jaxpr_analysis.py": "core/graph_analysis.py",  # an FX graph walker
    "kernels/attention_xla.py": "kernels/attention_chunked.py",  # plain chunked attention
    "launch/hlo_cost.py": "launch/graph_cost.py",  # the cost model over a fake trace
}
#: reference modules the port has no counterpart of, and why
NO_MODULE = {
    "kernels/compat.py": "jax-version shims for the Pallas TPU compiler params; "
                         "the CUDA kernels have no Pallas",
}
_PALLAS = "a Pallas TPU kernel's entry point; the port's CUDA wrapper of the same kernel " \
          "keeps the plain name"
_JAXPR = "walks a jaxpr; the port walks an FX graph (core/graph_analysis.py)"
_HLO = "parses XLA's HLO text; the port costs an FX graph (launch/graph_cost.py)"
_A5 = "an XLA plain path's precision override; waits for perf_iterate.py, its one " \
      "caller (ROADMAP A5)"
_BLOCKS = "every path of the port dispatches attention, paged attention and RMSNorm " \
          "through its core.blocks bindings (kernel on the card, plain version on the CPU)"
#: "module:name" -> why the port has no counterpart of that name
ABSENT = {
    "kernels/attention.py:flash_attention_pallas": _PALLAS,
    "kernels/fft.py:complex_matmul_pallas": _PALLAS,
    "kernels/fft.py:fft2d_pallas": _PALLAS,
    "kernels/matmul.py:matmul_pallas": _PALLAS,
    "kernels/matmul.py:schur_update_pallas": _PALLAS,
    "kernels/paged_attention.py:paged_attention_pallas": _PALLAS,
    "kernels/rmsnorm.py:rmsnorm_pallas": _PALLAS,
    "kernels/ssd.py:ssd_chunks_pallas": _PALLAS,
    "kernels/paged_attention.py:paged_attention_xla":
        "XLA's gather formulation; the port's plain version is paged_attention_torch",
    "metering/meters.py:TpuMeter": "reads a TPU's power; the card's is NvmlMeter",
    "analysis/features.py:CALLBACK_PRIMITIVES": _JAXPR,
    "analysis/features.py:CONTROL_FLOW_PRIMITIVES": _JAXPR,
    "analysis/features.py:jaxpr_of": _JAXPR,
    "analysis/resources.py:jaxpr_peak_bytes": _JAXPR,
    "core/jaxpr_analysis.py:JaxprReport": _JAXPR + "; GraphReport is its counterpart",
    "core/jaxpr_analysis.py:NamedCall": _JAXPR,
    "core/jaxpr_analysis.py:analyze_jaxpr": _JAXPR + "; analyze_graph is its counterpart",
    "core/jaxpr_analysis.py:avals_of": _JAXPR,
    "launch/dryrun.py:load_hlo": _HLO,
    "launch/dryrun.py:parse_collectives": _HLO,
    "launch/hlo_cost.py:Computation": _HLO,
    "launch/hlo_cost.py:Cost": _HLO,
    "launch/hlo_cost.py:HloCostModel": _HLO,
    "launch/hlo_cost.py:Inst": _HLO,
    "launch/hlo_cost.py:parse_module": _HLO,
    "launch/hlo_cost.py:shape_elems_bytes": _HLO,
    "core/planner/cost.py:PEAK_FLOPS": "a TPU's peak; launch/mesh.HW holds the H100's",
    "core/planner/cost.py:PEAK_HBM_BW": "a TPU's HBM rate; launch/mesh.HW holds the H100's",
    "kernels/attention_xla.py:CHUNKED_SCORES_DTYPE": _A5,
    "kernels/ref.py:RMSNORM_PRECISION": _A5,
    "kernels/ops.py:flash_attention": _BLOCKS,
    "kernels/ops.py:paged_attention": _BLOCKS,
    "kernels/ops.py:rmsnorm": _BLOCKS,
    "core/verify.py:search_offload_pattern":
        "the reference's deprecated shim over the single-then-combine search; the port's "
        "callers use planner.SingleThenCombine directly",
}

REF_MODULES = sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))


def _defined(path: pathlib.Path) -> set[str]:
    """Public top-level defs, classes and assigned names of a module."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            for target in node.targets:
                elts = target.elts if isinstance(target, ast.Tuple) else [target]
                out |= {e.id for e in elts if isinstance(e, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            out.add(node.target.id)
    return {n for n in out if not n.startswith("_")}


def _bound(path: pathlib.Path) -> set[str]:
    """Every name a module binds at its top level: its own and its imports."""
    out = _defined(path)
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            out |= {(a.asname or a.name).split(".")[0] for a in node.names}
    return out


def _port_of(module: str) -> pathlib.Path:
    return PORT / RENAMED.get(module, module)


@pytest.mark.parametrize("module", REF_MODULES)
def test_reference_module_has_its_names_in_the_port(module):
    if module in NO_MODULE:
        assert not _port_of(module).exists()
        return
    port = _port_of(module)
    assert port.exists(), f"no counterpart of repro/{module}"
    absent = {k.split(":")[1] for k in ABSENT if k.split(":")[0] == module}
    missing = sorted(_defined(REF / module) - _bound(port) - absent)
    assert not missing, f"repro_torch/{RENAMED.get(module, module)} lacks {missing}"


@pytest.mark.parametrize("key", sorted(ABSENT))
def test_every_exception_names_a_reference_name_the_port_lacks(key):
    module, name = key.split(":")
    assert ABSENT[key].strip()
    assert name in _defined(REF / module)
    assert name not in _bound(_port_of(module))


def test_renamed_modules_name_their_reference():
    for ref, port in RENAMED.items():
        assert (REF / ref).exists() and (PORT / port).exists() and not (PORT / ref).exists()
        doc = ast.get_docstring(ast.parse((PORT / port).read_text()))
        assert f"repro/{ref}" in doc


# -- the launcher's engine construction ---------------------------------------------------


ARGV = ["--arch", "llama3.2-1b", "--reduced", "--slots", "2", "--max-len", "48",
        "--page-size", "8", "--seed", "3", "--requests", "3", "--prompt-len", "12",
        "--len-jitter", "4", "--gen", "5", "--gen-jitter", "2"]
#: the CLI-only flags of ARGV (the rest are add_engine_args')
CLI_ONLY = {"--requests", "--prompt-len", "--len-jitter", "--gen", "--gen-jitter"}


def _parse(module, argv):
    ap = argparse.ArgumentParser()
    module.add_engine_args(ap)
    for flag in CLI_ONLY:
        ap.add_argument(flag, type=int)
    return ap.parse_args(argv)


def test_add_engine_args_takes_the_reference_flags():
    """Every engine flag of the reference's parser is the port's too."""
    def flags(module):
        ap = argparse.ArgumentParser()
        module.add_engine_args(ap)
        return {o for a in ap._actions for o in a.option_strings} - {"-h", "--help"}

    assert flags(jserve) <= flags(tserve)
    assert flags(tserve) - flags(jserve) == {"--layers", "--device"}


def test_same_argv_builds_engines_with_identical_f32_traces(monkeypatch):
    """The same argv (plus the port's ``--device cpu``) through each side's
    ``add_engine_args`` / ``build_engine``, both configs in f32 and the
    reference engine's weights carried into the port's: the requests each
    side's ``make_requests`` draws from the seed decode to the same tokens."""
    f32 = lambda get: lambda arch: dataclasses.replace(get(arch), compute_dtype="float32")  # noqa: E731
    monkeypatch.setattr(jserve, "get_config", f32(jget))
    monkeypatch.setattr(tserve, "get_config", f32(get_config))
    jargs = _parse(jserve, ARGV)
    jengine = jserve.build_engine(jargs)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jengine.params), jengine.cfg)
    made = tserve.ServeEngine
    monkeypatch.setattr(tserve, "ServeEngine",
                        lambda cfg, **kw: made(cfg, params=tparams, **kw))
    targs = _parse(tserve, ARGV + ["--device", "cpu"])
    tengine = tserve.build_engine(targs)
    assert tengine.cfg == dataclasses.replace(get_config("llama3.2-1b").reduced(),
                                              compute_dtype="float32")
    assert (tengine.n_slots, tengine.max_len, tengine.paged) == (2, 48, True)
    traces = []
    for module, engine, args in ((jserve, jengine, jargs), (tserve, tengine, targs)):
        requests = module.make_requests(engine.cfg, args, np.random.default_rng(args.seed))
        ids = [engine.submit(r) for r in requests]
        engine.run_until_idle(max_steps=500)
        traces.append([engine.completions[i].tokens for i in ids])
    assert traces[0] == traces[1] and len(traces[0]) == 3


@pytest.mark.parametrize("envelope, code", [("cpu-host-16g", 0), ("tiny-32m", 2)])
def test_preflight_takes_the_reference_call(envelope, code, capsys):
    """``preflight(args)`` sizes the flags' own config, as the reference's
    does; ``preflight(args, cfg)`` a config given."""
    argv = ["--arch", "llama3.2-1b", "--slots", "2", "--max-len", "64", "--page-size", "16",
            "--envelope", envelope] + (["--reduced"] if code == 0 else [])
    verdict = "preflight: OK" if code == 0 else "preflight: FAIL"
    assert jserve.preflight(_parse(jserve, argv)) == code
    assert verdict in capsys.readouterr()[code // 2]
    targs = _parse(tserve, argv + ["--device", "cpu"])
    assert tserve.preflight(targs) == code
    out = capsys.readouterr()
    assert verdict in out[code // 2] and "llama3.2-1b" in out.out
    assert tserve.preflight(targs, tserve.config_of(targs)) == code


# -- the last public names, each against its reference --------------------------


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _leaves(sub, f"{prefix}/{key}").items()}
    return {prefix: tree}


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-2.7b", "deepseek-v2-236b"])
def test_abstract_params_match_the_reference(arch):
    """``abstract_params`` of the same reduced config: the same leaves, each
    a storage-less tensor on the ``meta`` device of the reference leaf's
    shape and dtype; ``is_meta`` tells a ``ParamMeta`` from a tensor."""
    import torch

    from repro.models import lm as jlm
    from repro.models import params as jparams
    from repro_torch.models import lm, params

    metas = lm.build_metas(get_config(arch).reduced())
    got = _leaves(params.abstract_params(metas))
    want = _leaves(jparams.abstract_params(jlm.build_metas(jget(arch).reduced())))
    assert got.keys() == want.keys()
    for k, t in got.items():
        assert t.device.type == "meta", k
        assert tuple(t.shape) == tuple(want[k].shape), k
        assert str(t.dtype).split(".")[1] == str(want[k].dtype), k
    leaf = next(iter(_leaves(metas).values()))
    jleaf = next(iter(_leaves(jlm.build_metas(jget(arch).reduced())).values()))
    assert params.is_meta(leaf) and jparams.is_meta(jleaf)
    assert not params.is_meta(torch.zeros(1)) and not params.is_meta(metas)


@pytest.mark.parametrize("n", [1, 8, 33, 64])
def test_lu_ref_matches_the_reference(n):
    """The getrf oracle on the same seeded matrix: the packed factors within
    f32 rounding and the same 0-based pivots as ``jax.scipy``'s."""
    import torch

    from repro.kernels import ref as jref
    from repro_torch.kernels import ref

    a = np.random.default_rng(n).standard_normal((n, n)).astype(np.float32)
    lu, piv = ref.lu_ref(torch.from_numpy(a))
    jlu, jpiv = jref.lu_ref(jax.numpy.asarray(a))
    assert piv.dtype == torch.int32
    np.testing.assert_array_equal(piv.numpy(), np.asarray(jpiv))
    np.testing.assert_allclose(lu.numpy(), np.asarray(jlu), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ref.lu_reconstruct(lu, piv).numpy(), a, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("a, b", [
    ({}, {}),
    ({"add": 3, "mul": 1}, {"add": 3, "mul": 1}),
    ({"add": 3}, {"dot": 2}),
    ({"add": 3, "mul": 1, "exp": 4}, {"add": 1, "mul": 5}),
    ({"add": 2}, {}),
])
def test_histogram_similarity_matches_the_reference(a, b):
    from repro.core import jaxpr_analysis
    from repro_torch.core import graph_analysis

    got = graph_analysis.histogram_similarity(a, b)
    assert got == jaxpr_analysis.histogram_similarity(a, b)
    assert got == graph_analysis.histogram_similarity(b, a)


def test_histogram_similarity_of_traced_graphs():
    """A traced function is 1 against itself and less against another."""
    import torch

    from repro_torch.core import graph_analysis

    x = torch.ones(4, 4)
    one = graph_analysis.trace_report(lambda t: torch.exp(t) + t, x).histogram
    two = graph_analysis.trace_report(lambda t: (t @ t).sum(), x).histogram
    assert graph_analysis.histogram_similarity(one, one) == 1.0
    assert graph_analysis.histogram_similarity(one, two) < 1.0


def test_train_state_carries_the_train_cli_state():
    """``TrainState`` has the reference's fields, and holds what the
    training CLI's ``build`` makes; one step of the CLI's step through it."""
    from repro.launch import train as jtrain
    from repro_torch.launch import train

    assert ([f.name for f in dataclasses.fields(train.TrainState)]
            == [f.name for f in dataclasses.fields(jtrain.TrainState)])
    args = train.build_parser().parse_args(
        ["--arch", "llama3.2-1b", "--reduced", "--layers", "1", "--batch", "2", "--seq", "8",
         "--device", "cpu"])
    cfg, data, step_fn, params, opt_state, _ = train.build(args)
    ts = train.TrainState(params, opt_state)
    import torch

    batch = {k: torch.from_numpy(v) for k, v in data.batch_at(0).items()}
    new_params, new_opt, metrics = step_fn(ts.params, ts.opt_state, batch)
    ts = train.TrainState(new_params, new_opt)
    assert int(ts.opt_state.step) == 1 and np.isfinite(float(metrics["loss"]))
