"""dilqr_tpu_torch.models: the envs (cartpole, pendulum, rocket), the
learned MLP model (nn_dynamics) and its cartpole preset (cartpole_mlp),
affine dynamics and the slew-rate control-passthrough wrapper."""
from . import affine, cartpole, cartpole_mlp, ctrl_passthrough, nn_dynamics, pendulum, rocket

__all__ = ["affine", "cartpole", "cartpole_mlp", "ctrl_passthrough", "nn_dynamics", "pendulum",
           "rocket"]
