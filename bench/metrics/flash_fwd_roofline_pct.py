"""flash_fwd_roofline_pct (%, device trace; layer: kernels): the bound
seconds of the traced steps' prefill attention (one causal flash forward a
layer a prompt; frozen formula ``work.flash_forward_work``) over the
device seconds of the flash forward kernels."""

from bench.harness import readers


def read(run):
    return readers.roofline_pct(run, readers.FLASH_KERNELS, readers.flash_bound_s(run))
