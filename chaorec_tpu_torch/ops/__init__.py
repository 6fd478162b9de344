"""The port's operations; ``kernel_wrappers`` lists the wrappers of its
hand-written kernels, each counting its launches in ``launches``."""


def kernel_wrappers():
    """Every kernel wrapper, in the order of the kernels' sources
    (``csrc/fused_mha.cu``, ``fused_mha_bwd.cu``, ``row_adam.cu``,
    ``streaming_lse.cu``, ``prefix_scan.cu``, ``csr_spmm.cu``)."""
    from chaorec_tpu_torch.ops.csr_spmm import csr_spmm
    from chaorec_tpu_torch.ops.fused_attn import fused_mha, fused_mha_bwd
    from chaorec_tpu_torch.ops.prefix_scan import prefix_cumsum
    from chaorec_tpu_torch.ops.row_adam import fused_row_adam
    from chaorec_tpu_torch.ops.streaming_lse import (streaming_lse_dk, streaming_lse_dq,
                                                     streaming_lse_fwd)

    return (fused_mha, fused_mha_bwd, fused_row_adam, streaming_lse_fwd, streaming_lse_dq,
            streaming_lse_dk, prefix_cumsum, csr_spmm)
