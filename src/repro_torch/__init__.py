"""``repro_torch`` — the PyTorch/CUDA port of ``repro``.

The package mirrors ``repro``'s layout (``configs``, ``core``, ``kernels``,
``models``, ``serve``, ``launch``) so each module's counterpart is easy to
find.  It imports ``torch`` and never ``jax`` or anything under ``repro``;
the JAX package is the reference the tests hold the port against.

Entry points (``serve.ServeEngine``, ``python -m repro_torch.launch.serve``)
run on the CUDA card unless the caller passes ``device="cpu"``.  The three
hand-written Hopper kernels under ``kernels/csrc/`` are built with ``nvcc``
at first use (``kernels/build.py``).
"""
