"""moe_experts_read_pct (%, program counter; layer: model step): the share
of experts whose weights the MoE's grouped route read, over the experts it
held, summed over the run's grouped calls (the decode steps since the
engine was made: warm-up and window), from the device tally that the
route's pack kernel keeps (``repro_torch.kernels.moe_experts.read_pct``).
None where the program keeps no such tally or made no grouped call."""


def read(run):
    try:
        from repro_torch.kernels import moe_experts
    except ImportError:
        return None
    return moe_experts.read_pct()
