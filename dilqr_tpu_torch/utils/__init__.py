"""dilqr_tpu_torch.utils"""
