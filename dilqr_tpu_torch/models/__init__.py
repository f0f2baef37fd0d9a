"""dilqr_tpu_torch.models: the envs (cartpole, pendulum, rocket), the
learned MLP model (nn_dynamics), affine dynamics and the slew-rate
control-passthrough wrapper."""
from . import affine, cartpole, ctrl_passthrough, nn_dynamics, pendulum, rocket

__all__ = ["affine", "cartpole", "ctrl_passthrough", "nn_dynamics", "pendulum", "rocket"]
