"""dilqr_tpu_torch.diff"""
