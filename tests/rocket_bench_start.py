"""bench.py's rocket start (bench.py:320-325), shared by the port's rocket
tests. It imports no JAX: tests/test_torch_cuda.py runs without it."""
import numpy as np


def bench_start(B, rng, scale=1.0, dtype=np.float32):
    """[B, 13] states near hover 2 m up, the perturbations times ``scale``;
    ``rng`` is a seed or a numpy RandomState (drawn from in place)."""
    if not isinstance(rng, np.random.RandomState):
        rng = np.random.RandomState(rng)
    return np.concatenate([
        np.array([2.0, 0, 0]) + 0.2 * scale * rng.randn(B, 3),
        0.05 * scale * rng.randn(B, 3),
        np.tile(np.array([1.0, 0, 0, 0]), (B, 1)) + 0.005 * scale * rng.randn(B, 4),
        0.01 * scale * rng.randn(B, 3)], 1).astype(dtype)
