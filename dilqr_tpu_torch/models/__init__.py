"""dilqr_tpu_torch.models"""
