"""The port's counterparts of the JAX package's examples/ scripts. Each is a
module with ``main(argv=None)`` that prints what the JAX script prints and
returns its summary numbers; each runs on the card by default (``--device
cuda``) and on the CPU with ``--device cpu``:

    python -m dilqr_tpu_torch.examples.<name> [--device cpu] [flags]

cost_sweep, closed_loop, mismatch_loop, rocket_landing, sysid_pendulum,
external_plant."""
