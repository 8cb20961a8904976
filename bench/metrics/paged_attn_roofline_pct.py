"""paged_attn_roofline_pct (%, device trace; layer: kernels): the bound
seconds of the traced steps' paged-attention calls (one a layer a decode
step, at the rows' resident lengths; frozen formula
``work.paged_decode_work``) over the device seconds of the
``paged_attention_*`` kernels (the split or latent walk and its merge)."""

from bench.harness import readers


def read(run):
    return readers.roofline_pct(run, readers.PAGED_KERNELS, readers.paged_bound_s(run))
