"""dilqr_tpu_torch.ops"""
