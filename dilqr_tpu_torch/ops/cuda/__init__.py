"""dilqr_tpu_torch.ops.cuda: hand-written CUDA kernels, their wrappers and their plain versions."""
