"""kv_stranded_pct (%, program counter; layer: KV pool): the window's mean of
the engine's per-step stranded share of reserved KV capacity
(``engine.metrics()['mean_stranded_pct']`` at the window's two ends)."""


def read(run):
    return run.kv_stranded_pct
