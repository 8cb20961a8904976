"""Evaluation applications (paper §5.1.1) — the port of ``repro/apps``.

Naive CPU-oriented ports of the *Numerical Recipes in C* routines the paper
offloads: the 2-D FFT sample application and the LU-decomposition matrix
application, verbatim from the reference.  Only their loop-offload device
stages are torch; they are the *offload source*, not the optimised shelf.
"""

from repro_torch.apps import fourier, matrix  # noqa: F401
from repro_torch.apps.common import Stage, build_staged_variant  # noqa: F401
