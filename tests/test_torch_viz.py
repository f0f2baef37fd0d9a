"""The port's viz (dilqr_tpu_torch/viz.py) as tests/test_utils.py:78-141
drives the JAX package's: the render hooks on tensors, files written, and
the rocket animation's geometry, held against dilqr_tpu.viz's on the same
inputs (to 1e-12: the same numpy arithmetic)."""
import os
import tempfile

import numpy as np
import torch

from dilqr_tpu import viz as jviz
from dilqr_tpu_torch import viz


def test_render_hooks_smoke_on_tensors():
    ax = viz.pendulum_frame(torch.tensor([0.8, 0.6, 0.0]))
    assert ax is not None
    ax = viz.cartpole_frame(torch.tensor([0.1, 0.0, 0.9, 0.43, 0.0], requires_grad=True))
    assert ax is not None
    xs = torch.from_numpy(np.random.RandomState(0).randn(5, 13).astype(np.float32))
    us = torch.from_numpy(np.random.RandomState(1).randn(5, 3).astype(np.float32))
    with tempfile.TemporaryDirectory() as d:
        p = viz.rocket_trajectory(xs, us, path=os.path.join(d, "r.png"))
        assert os.path.exists(p)
        g = viz.rocket_animation(xs, us, path=os.path.join(d, "r.gif"))
        assert os.path.exists(g) and os.path.getsize(g) > 0
        frames = viz.save_frames(viz.pendulum_frame, torch.tensor([[1.0, 0.0, 0.0],
                                                                    [0.0, 1.0, 0.0]]),
                                 os.path.join(d, "f"))
        assert len(frames) == 2 and all(os.path.exists(f) for f in frames)


def test_rocket_animation_geometry():
    """Body segment of the requested length, tip above tail for an upright
    rocket, flame opposite the body-frame thrust (reference
    rocket.py:961-994)."""
    xs = torch.zeros(3, 13)
    xs[:, 0] = torch.tensor([2.0, 1.5, 1.0])  # descending altitude
    xs[:, 6] = 1.0                            # q = (1, 0, 0, 0)
    us = torch.zeros(3, 3)
    us[:, 0] = 8.0                            # +x body thrust
    com, tail, tip, flame = viz._rocket_geometry(xs, us, rocket_len=0.5)
    np.testing.assert_allclose(np.linalg.norm(tip - tail, axis=1), 0.5, atol=1e-6)
    assert (tip[:, 0] > tail[:, 0]).all()
    assert (flame[:, 0] < tail[:, 0]).all()
    np.testing.assert_allclose(flame[:, 1:], tail[:, 1:], atol=1e-6)


def test_rocket_geometry_matches_jax_package():
    rng = np.random.RandomState(2)
    xs, us = rng.randn(6, 13), rng.randn(6, 3)
    got = viz._rocket_geometry(torch.from_numpy(xs), torch.from_numpy(us), 0.7)
    want = jviz._rocket_geometry(xs, us, 0.7)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-12)
