"""codec_ms_per_step: device milliseconds a training step spends in the
NDSC codec's kernels (`kernels/ops.py` -> csrc/quantencode.cu,
quantpack.cu, fwht.cu), matched by the kernel names below in the traced
window, over the steps traced."""
LAYER = "codec (dist/gradcomp.py -> kernels/ops.py)"
MOVES = "train_tokens_per_s"
KERNELS = ("encode_warp_kernel", "encode_smem_kernel", "encode_row_kernel",
           "encode_cluster_kernel", "unpack_flat_kernel",
           "unpack_rows_kernel", "quantize_rows_kernel",
           "quantize_flat_kernel", "fwht_warp_kernel", "fwht_smem_kernel",
           "fwht_row_kernel", "fwht_cols_kernel")


def read(trace):
    secs = trace.op_seconds(KERNELS)
    if not trace.steps or secs <= 0.0:
        return None
    return 1e3 * secs / trace.steps
