"""dilqr_tpu_torch.il"""
