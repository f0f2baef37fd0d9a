"""dilqr_tpu_torch.parallel: the batch sharded over ranks and devices
(counterpart of ``dilqr_tpu/parallel``). See multihost.py (one rank a
device, on torch.distributed), mesh.py (several devices of one process),
comm.py (the collectives and the batch-global decisions) and audit.py (the
record of what crossed ranks)."""
