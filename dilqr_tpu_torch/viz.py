"""Rendering hooks for the physics environments (counterpart of
``dilqr_tpu/viz.py``).

Mirrors the reference's matplotlib renderers -- pendulum.get_frame
(env_dx/pendulum.py:97-115), cartpole.get_frame (env_dx/cartpole.py:841-857)
and the rocket 3-D trajectory animation (env_dx/rocket.py:825-994) -- as
optional utilities (matplotlib imported lazily; the solver never depends on
this module). Every array argument is a numpy array or a tensor, on any
device: a tensor is read through ``.detach().cpu().numpy()``.
"""
from __future__ import annotations

import numpy as np


def _np(a, dtype=None) -> np.ndarray:
    """A tensor (any device, grad or not) or array-like as a numpy array."""
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype)


def _mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def pendulum_frame(x, ax=None):
    """Draw one pendulum state (cos th, sin th, th_dot). Reference
    pendulum.py:97-115 (rod of length l from the pivot)."""
    plt = _mpl()
    x = _np(x)
    cos_th, sin_th = float(x[0]), float(x[1])
    if ax is None:
        _, ax = plt.subplots(figsize=(4, 4))
    ax.plot((0.0, sin_th), (0.0, cos_th), color="k", lw=4)
    ax.set_xlim(-1.2, 1.2)
    ax.set_ylim(-1.2, 1.2)
    ax.set_aspect("equal")
    return ax


def cartpole_frame(x, length: float = 0.5, ax=None):
    """Draw one cartpole state (p, p_dot, cos th, sin th, th_dot).
    Reference cartpole.py:841-857 (cart marker + pole of length 2l)."""
    plt = _mpl()
    from matplotlib import patches

    x = _np(x)
    p, cos_th, sin_th = float(x[0]), float(x[2]), float(x[3])
    if ax is None:
        _, ax = plt.subplots(figsize=(6, 3))
    cart_w, cart_h = 0.4, 0.2
    ax.add_patch(
        patches.Rectangle(
            (p - cart_w / 2, -cart_h / 2), cart_w, cart_h, color="k"
        )
    )
    ax.plot(
        (p, p + 2 * length * sin_th),
        (0.0, 2 * length * cos_th),
        color="tab:blue",
        lw=3,
    )
    ax.set_xlim(p - 2.5, p + 2.5)
    ax.set_ylim(-1.5, 1.5)
    ax.set_aspect("equal")
    return ax


def rocket_trajectory(xs, us=None, path: str = None):
    """3-D soft-landing trajectory plot for the 13-state rocket
    (r, v, q, w). Simplified equivalent of the reference's animation
    (rocket.py:825-994): position track + thrust vectors. ``xs`` [T, 13]
    (or [T, B, 13]; batch element 0 is drawn). Saves to ``path`` if given,
    else returns the figure."""
    plt = _mpl()
    xs = _np(xs)
    if xs.ndim == 3:
        xs = xs[:, 0]
    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot(projection="3d")
    # reference draws x up: state is (rx=altitude, ry, rz, ...)
    ax.plot(xs[:, 1], xs[:, 2], xs[:, 0], "-o", ms=2, color="tab:blue")
    if us is not None:
        us = _np(us)
        if us.ndim == 3:
            us = us[:, 0]
        n = min(len(us), len(xs))
        ax.quiver(
            xs[:n, 1], xs[:n, 2], xs[:n, 0],
            -us[:n, 1], -us[:n, 2], -us[:n, 0],
            length=0.05, color="tab:red", normalize=False,
        )
    ax.set_xlabel("y")
    ax.set_ylabel("z")
    ax.set_zlabel("altitude x")
    if path is not None:
        fig.savefig(path, dpi=120)
        plt.close(fig)
        return path
    return fig


def _quat_to_dcm_inertial(q):
    """3x3 body->inertial rotation from a (possibly unnormalized)
    quaternion [q0, q1, q2, q3] (same convention as
    models/rocket._dcm_body_to_inertial_rows, reference rocket.py:116-121)."""
    q = _np(q, float)
    q = q / (np.linalg.norm(q) + 1e-4)
    q0, q1, q2, q3 = q
    c_bi = np.array([
        [1 - 2 * (q2**2 + q3**2), 2 * (q1 * q2 + q0 * q3),
         2 * (q1 * q3 - q0 * q2)],
        [2 * (q1 * q2 - q0 * q3), 1 - 2 * (q1**2 + q3**2),
         2 * (q2 * q3 + q0 * q1)],
        [2 * (q1 * q3 + q0 * q2), 2 * (q2 * q3 - q0 * q1),
         1 - 2 * (q1**2 + q2**2)],
    ])
    return c_bi.T


def _rocket_geometry(xs, us, rocket_len):
    """Per-frame draw points for the rocket body and thrust vector.

    Returns (com, tail, tip, flame) each [T, 3] in inertial coordinates:
    the body spans tail..tip through the center of mass along the body
    x-axis, the thrust applies at the tail (gimbal point) and the flame
    segment points opposite the body-frame thrust force, scaled by
    |f| / max|f| (reference rocket.py:961-994 draws the same four
    points)."""
    xs = _np(xs, float)
    us = _np(us, float)
    T = min(len(xs), len(us))
    max_f = max(float(np.linalg.norm(us, axis=-1).max()), 1e-9)
    half = np.array([rocket_len / 2.0, 0.0, 0.0])
    com = xs[:T, 0:3]
    tail = np.empty((T, 3))
    tip = np.empty((T, 3))
    flame = np.empty((T, 3))
    for t in range(T):
        R = _quat_to_dcm_inertial(xs[t, 6:10])
        arm = R @ half
        tail[t] = com[t] - arm
        tip[t] = com[t] + arm
        flame[t] = tail[t] - (R @ us[t, 0:3]) / max_f * rocket_len
    return com, tail, tip, flame


def rocket_animation(xs, us, rocket_len: float = 0.5, path: str = None,
                     fps: int = 10, dt: float = 0.1):
    """Animated 3-D rocket landing: trajectory trace, rigid body segment,
    thrust-vector flame, and a time label (parity with the reference's
    play_animation, rocket.py:825-994, minus the unused demo-overlay
    second rocket). ``xs`` [T, 13] (or [T, B, 13]: element 0), ``us``
    [T, 3] likewise. Saves a GIF when ``path`` ends in .gif (Pillow
    writer, no ffmpeg dependency), else returns the FuncAnimation."""
    plt = _mpl()
    from matplotlib import animation

    xs = _np(xs)
    us = _np(us)
    if xs.ndim == 3:
        xs = xs[:, 0]
    if us.ndim == 3:
        us = us[:, 0]
    com, tail, tip, flame = _rocket_geometry(xs, us, rocket_len)
    T = len(tail)

    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot(projection="3d")
    # state is (rx=altitude "up", ry, rz, ...): draw y/z in the ground
    # plane and altitude on the vertical axis
    lim = max(1.0, float(np.abs(xs[:, 1:3]).max()) * 1.1)
    ax.set_xlim(-lim, lim)
    ax.set_ylim(-lim, lim)
    ax.set_zlim(0.0, max(1.0, float(xs[:, 0].max()) * 1.1))
    ax.set_xlabel("y")
    ax.set_ylabel("z")
    ax.set_zlabel("altitude x")
    # landing pad
    th = np.linspace(0, 2 * np.pi, 64)
    ax.plot(0.5 * np.cos(th), 0.5 * np.sin(th), 0.0 * th,
            color="tab:green", alpha=0.6)

    (l_traj,) = ax.plot(com[:1, 1], com[:1, 2], com[:1, 0],
                        color="tab:blue", lw=1)
    (l_body,) = ax.plot([tail[0, 1], tip[0, 1]], [tail[0, 2], tip[0, 2]],
                        [tail[0, 0], tip[0, 0]], color="k", lw=4)
    (l_flame,) = ax.plot([tail[0, 1], flame[0, 1]],
                         [tail[0, 2], flame[0, 2]],
                         [tail[0, 0], flame[0, 0]], color="tab:red", lw=2)
    label = ax.text2D(0.05, 0.95, "t = 0.0 s", transform=ax.transAxes)

    def update(t):
        l_traj.set_data(com[: t + 1, 1], com[: t + 1, 2])
        l_traj.set_3d_properties(com[: t + 1, 0])
        l_body.set_data([tail[t, 1], tip[t, 1]], [tail[t, 2], tip[t, 2]])
        l_body.set_3d_properties([tail[t, 0], tip[t, 0]])
        l_flame.set_data([tail[t, 1], flame[t, 1]],
                         [tail[t, 2], flame[t, 2]])
        l_flame.set_3d_properties([tail[t, 0], flame[t, 0]])
        label.set_text(f"t = {t * dt:.1f} s")
        return l_traj, l_body, l_flame, label

    ani = animation.FuncAnimation(fig, update, frames=T,
                                  interval=1000 / fps, blit=False)
    if path is not None:
        if not path.endswith(".gif"):
            raise ValueError(
                "rocket_animation writes GIFs (Pillow; no ffmpeg in this "
                f"environment): got {path!r}. Pass a .gif path, or call "
                "with path=None and save the returned FuncAnimation with "
                "a writer of your choice."
            )
        ani.save(path, writer=animation.PillowWriter(fps=fps))
        plt.close(fig)
        return path
    return ani


def save_frames(frames_fn, xs, prefix: str):
    """Render a trajectory to numbered PNGs (reference il_exp-style frame
    dumps). frames_fn: pendulum_frame or cartpole_frame."""
    plt = _mpl()
    paths = []
    for i, x in enumerate(_np(xs)):
        ax = frames_fn(x)
        p = f"{prefix}_{i:03d}.png"
        ax.figure.savefig(p, dpi=100)
        plt.close(ax.figure)
        paths.append(p)
    return paths
