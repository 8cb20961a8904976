"""The offload pipeline's compiled units on the CPU: the blocked LU
(``repro_torch.kernels.lu``) and the loop-offload stages
(``repro_torch.apps.common``) as captured programs.

A CUDA graph needs the card.  Here ``DryGraph`` stands in for one (capture
runs the unit's Python and none of its writes, a replay runs the unit), so
the programs' keys, static buffers, capture counts and launch counting run
on the CPU; ``chip_smoke.py`` phase 12 holds a real replay against the
eager call on the card.  The LU itself is held against the reference's
``lu_blocked`` (XLA, and the Pallas trailing update in interpret mode) on
the application's own input (an orthogonal matrix, condition number 1):
identical pivots, packed factors within 1e-4, the tolerance of
``test_torch_offload_kernels.py``'s LU parity (the same f32 eliminations,
the triangular solve's and the trailing update's dot products summed in
another order: up to 3.5e-5 apart at n=256).  An orthogonal matrix plus
0.1-scale noise is not used here: at n >= 192 its pivots fall to ~0.02, the
f32 rounding of the two packages is amplified past the 1.6% gap between
two pivot candidates (column 100 at n=192), and each picks a different,
equally valid row.  ``lu_blocked`` must read nothing back from the device,
or it could not be captured.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import repro_torch.kernels as kernels
from repro.apps import fourier as jfourier
from repro.apps import matrix as jmatrix
from repro.kernels import lu as jlu
from repro.kernels import ops as jops
from repro_torch.apps import common, fourier, matrix
from repro_torch.kernels import lu as tlu
from repro_torch.kernels import matmul as tmm
from repro_torch.kernels import ops as tops
from repro_torch.runtime import programs as runtime_programs

LU_TOL = 1e-4


class _NoWrites(TorchDispatchMode):
    """Runs every op but those that write a tensor, as a capture does."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func._schema.is_mutable:
            return args[0]
        return func(*args, **(kwargs or {}))


class DryGraph:
    """A CUDA graph's contract on the CPU (stands in for ``runtime.programs.Graph``)."""

    def __init__(self, run, pool):
        self.run = run
        with _NoWrites():
            self.outputs = run()

    def replay(self):
        held = kernels.counters()
        new = self.run()
        kernels.add_counters({k: held[k] - n for k, n in kernels.counters().items()})
        flat_out = runtime_programs.leaves(self.outputs)
        for out, value in zip(flat_out, runtime_programs.leaves(new)):
            if isinstance(out, torch.Tensor) and out.data_ptr() != value.data_ptr():
                out.copy_(value)
        return self.outputs


def _input(n, seed):
    return jmatrix.make_input(n, seed=seed).astype(np.float32)


# -- the LU against the reference -------------------------------------------------------

#: (n, nb, reference backend); nb None is ops.lu's default (32 below 512).
#: The reference's Pallas trailing update needs its 128-wide blocks to tile,
#: so at n=192 it runs at nb=64, as tests/test_kernels_lu.py runs it.
LU_CASES = [
    (192, 32, "xla"), (192, 64, "pallas"),
    (256, 128, "xla"), (256, 128, "pallas"),
    (100, None, "xla"), (100, None, "pallas"),
]


@pytest.mark.parametrize("n,nb,backend", LU_CASES)
def test_lu_matches_reference(n, nb, backend):
    a = _input(n, seed=n)
    pallas = backend == "pallas"
    jlu_p, jpiv = jops.lu(jnp.asarray(a), nb=nb, backend=backend, interpret=pallas)
    lu_p, piv = tops.lu(a, nb=nb, backend="torch", device="cpu")
    np.testing.assert_array_equal(piv.numpy(), np.asarray(jpiv))
    np.testing.assert_allclose(lu_p.numpy(), np.asarray(jlu_p), rtol=0, atol=LU_TOL)

    # lu_blocked itself, on the identity-padded input ops.lu factors
    nb = nb or 32
    npad = -(-n // nb) * nb
    ap = np.eye(npad, dtype=np.float32)
    ap[:n, :n] = a
    jout = jlu.lu_blocked(jnp.asarray(ap), nb=nb, n_real=n, use_pallas=pallas,
                          interpret=pallas)
    out = tlu.lu_blocked(torch.from_numpy(ap), nb=nb, n_real=n,
                         schur=tmm.schur_update_torch)
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(jout[1]))
    np.testing.assert_allclose(out[0].numpy(), np.asarray(jout[0]), rtol=0, atol=LU_TOL)
    assert float(out[2]) == float(jout[2])


def _nr_sequence(piv, rows):
    """Row order after the NR swap sequence, the host loop the device
    permutation replaced."""
    perm = list(range(rows))
    for j, i in enumerate(piv):
        perm[j], perm[i] = perm[i], perm[j]
    return perm


@pytest.mark.parametrize("rows,nb", [(192, 32), (128, 128), (37, 8)])
def test_device_permutation_equals_nr_swap_sequence(rows, nb):
    rng = np.random.default_rng(rows)
    for _ in range(5):
        # NR pivots sit at or below the diagonal; any index swaps as well
        piv = [int(rng.integers(j, rows)) for j in range(nb)]
        anywhere = [int(rng.integers(0, rows)) for _ in range(nb)]
        for p in (piv, anywhere):
            got = tlu._swap_permutation(torch.tensor(p, dtype=torch.int32), rows)
            assert got.tolist() == _nr_sequence(p, rows)


class _HostRead(RuntimeError):
    pass


def _no_host_reads(monkeypatch):
    def refuse(name):
        def read(*_a, **_k):
            raise _HostRead(f"Tensor.{name} reads the device from the host")
        return read

    for name in ("tolist", "item", "cpu", "numpy", "__bool__", "__int__", "__float__"):
        monkeypatch.setattr(torch.Tensor, name, refuse(name))


@pytest.mark.parametrize("n,nb", [(192, 32), (128, 64)])
def test_lu_blocked_makes_no_host_sync(n, nb, monkeypatch):
    a = torch.from_numpy(_input(n, seed=3))
    want = tlu.lu_blocked(a, nb=nb, schur=tmm.schur_update_torch)
    _no_host_reads(monkeypatch)
    with pytest.raises(_HostRead):  # the patches do bite
        a.sum().item()
    got = tlu.lu_blocked(a, nb=nb, schur=tmm.schur_update_torch)
    lu_p, piv, d = tops.lu_nr_compat(a[:100, :100].contiguous(), device="cpu")
    monkeypatch.undo()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert d.shape == () and float(d) in (1.0, -1.0)


# -- the LU program ---------------------------------------------------------------------


def _counting_schur(c, a, b, **blocks):
    """The plain trailing update, counted as the kernel's wrapper counts."""
    tmm.schur_update.launches += 1
    return tmm.schur_update_torch(c, a, b)


@pytest.mark.parametrize("n,nb", [(192, 32), (100, 32), (256, 128)])
def test_lu_program_captures_once_and_replays(n, nb, monkeypatch):
    """Each call copies the input into the identity-padded static buffer; the
    first call runs eagerly, the second captures and replays, later calls
    replay; every call returns what ops.lu returns, in fresh tensors; a
    replay counts the Schur updates an eager call launches."""
    monkeypatch.setattr(runtime_programs, "Graph", DryGraph)
    program = tlu._LUProgram(n, nb, _counting_schur, torch.device("cpu"))
    kernels.reset_launches()
    outs = []
    for seed in (1, 2, 2, 3):
        a = _input(n, seed=seed)
        before = tmm.schur_update.launches
        outs.append(program(torch.from_numpy(a)))
        want_lu, want_piv = tops.lu(a, nb=nb, backend="torch", device="cpu")
        assert torch.equal(outs[-1][0], want_lu) and torch.equal(outs[-1][1], want_piv)
        assert tmm.schur_update.launches - before == -(-n // nb) - 1
    assert torch.equal(outs[1][0], outs[2][0]) and outs[1][0].data_ptr() != outs[2][0].data_ptr()
    stats = program.summary()
    assert (stats["calls"], stats["eager_calls"], stats["captures"], stats["replays"]) == (4, 1, 1, 3)
    assert stats["launches_per_replay"] == {"schur_update": -(-n // nb) - 1}
    assert torch.equal(program.static[n:, n:], torch.eye(program.static.shape[0] - n))


def test_lu_program_needs_the_card():
    with pytest.raises(ValueError, match="CUDA"):
        tlu.lu_program(torch.eye(4), nb=4)


# -- the loop-offload stages ------------------------------------------------------------

APPS = {
    "fft": (fourier.FFT_STAGES, fourier.build_fft_variant, jfourier.build_fft_variant,
            lambda: fourier.make_input(64)),
    "lu": (matrix.LU_STAGES, matrix.build_lu_variant, jmatrix.build_lu_variant,
           lambda: matrix.make_input(64)),
}
GENOMES = [(app, tuple(int(b) for b in np.binary_repr(i, len(APPS[app][0]))))
           for app in APPS for i in range(2 ** len(APPS[app][0]))]


@pytest.mark.parametrize("app,genome", GENOMES, ids=[f"{a}-{''.join(map(str, g))}"
                                                     for a, g in GENOMES])
def test_staged_variant_matches_reference(app, genome):
    """Every variant of both apps at n=64 against the reference's: the
    naive stages are the same numpy code, the offloaded ones f32 (complex64)
    on both sides, so they agree to f32 rounding of the spectrum's / the
    determinant's size."""
    _, build, jbuild, make = APPS[app]
    x = make()
    got = np.asarray(build(genome, device="cpu")(x))
    want = np.asarray(jbuild(genome)(x))
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5 * scale)


@pytest.mark.parametrize("app", sorted(APPS))
def test_stage_programs_replay_like_direct_calls(app, monkeypatch):
    """Each offloaded stage as a graphed program: its input copied into one
    static buffer per shape, one capture, and every call's output equal to
    the stage called directly."""
    monkeypatch.setattr(runtime_programs, "Graph", DryGraph)
    stages, _, _, make = APPS[app]
    state = make()
    for stage in stages:
        program = runtime_programs.Program(f"stage:{stage.name}", stage.offloaded, "cpu")
        program.graphed = True
        inputs = []
        for _ in range(3):
            arg = tuple(tops.as_tensor(s, "cpu") for s in state) if isinstance(state, tuple) \
                else tops.as_tensor(state, "cpu")
            out = program(arg)
            want = stage.offloaded(arg)
            for o, w in zip(runtime_programs.leaves(out), runtime_programs.leaves(want)):
                assert torch.equal(o, w)
            inputs.append([b.data_ptr() for b in program._buffers[next(iter(program._buffers))]
                           if isinstance(b, torch.Tensor)])
        assert inputs[0] == inputs[1] == inputs[2]  # one static buffer set
        assert program.summary()["captures"] == 1 and program.summary()["replays"] == 2
        state = stage.naive(state)


def test_stage_programs_shared_across_variants():
    """A stage's program is made once per device and shared by every
    variant offloading it (the reference's jit cache)."""
    stages = matrix.LU_STAGES
    common.build_staged_variant(stages, (1, 1, 1), device="cpu")
    first = [common.stage_program(s, torch.device("cpu")) for s in stages]
    common.build_staged_variant(stages, (0, 1, 0), device="cpu")
    assert [common.stage_program(s, torch.device("cpu")) for s in stages] == first
    assert len({id(p) for p in first}) == len(stages)
