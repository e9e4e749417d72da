"""Published peaks of the cards the benchmark runs on (NVIDIA's data
sheet, H100 SXM5 at its 700 W limit, dense rates without sparsity)."""

# Dense bfloat16 tensor-core FLOP/s, keyed on torch.cuda.get_device_name().
BF16_PEAK_FLOPS = {"NVIDIA H100 80GB HBM3": 989.4e12}
# HBM3 bytes/s and float32 FLOP/s outside the tensor cores: the bounds of
# the hand-written kernels, none of which uses a tensor core.
HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}
F32_FLOPS = {"NVIDIA H100 80GB HBM3": 67e12}


def least_ms(kind, nbytes, flops):
    """The least milliseconds a call can take on card `kind`: the larger
    of its bytes at the memory's rate and its operations at float32's."""
    return max(nbytes / HBM_BYTES_PER_S[kind], flops / F32_FLOPS[kind]) * 1e3
