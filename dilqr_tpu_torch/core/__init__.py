"""dilqr_tpu_torch.core"""
