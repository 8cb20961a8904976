"""``repro_torch.serve`` — request-level serving on the card (the port of
``repro.serve``).

Quickstart::

    from repro_torch.serve import Request, ServeEngine

    engine = ServeEngine("llama3.2-1b", n_slots=8, max_len=1024, page_size=16)
    engine.submit(Request(prompt, max_new_tokens=32))
    completions = engine.run_until_idle()

``python -m repro_torch.launch.serve`` is the CLI over this engine.
"""

from repro_torch.serve.engine import EngineStats, PhaseTelemetry, ServeEngine  # noqa: F401
from repro_torch.serve.kv import PagePool, PageTable, PoolExhausted  # noqa: F401
from repro_torch.serve.request import Completion, Request, Token  # noqa: F401
from repro_torch.serve.sampler import Sampler, sample_tokens  # noqa: F401
from repro_torch.serve.scheduler import Scheduler  # noqa: F401
