"""Unicycle kinematics (port of ``repro/core/kinematics.py``).

One implementation for numpy arrays (the scenario generators) and torch
tensors (the rollout engine's tick on the device): same midpoint scheme,
same speed clamp, same constants.
"""
from __future__ import annotations

import numpy as np
import torch

DT = 0.5          # seconds per simulation step
MAX_SPEED = 25.0  # m/s clamp in the unicycle integrator


def _is_torch(x) -> bool:
    return isinstance(x, torch.Tensor)


def wrap_angle(theta):
    """Wrap angles to (-pi, pi], numpy or torch alike."""
    xp = torch if _is_torch(theta) else np
    return xp.arctan2(xp.sin(theta), xp.cos(theta))


def step_kinematics(pose, speed, accel, yaw_rate, dt: float = DT):
    """Midpoint-speed unicycle step.

    pose (..., 3) = (x, y, theta); speed/accel/yaw_rate broadcastable to
    pose[..., 0]. Returns (new_pose, new_speed), in the array type of
    ``pose``.
    """
    if _is_torch(pose):
        speed_new = torch.clamp(speed + accel * dt, 0.0, MAX_SPEED)
        cos, sin, stack = torch.cos, torch.sin, torch.stack
    else:
        speed_new = np.clip(speed + accel * dt, 0.0, MAX_SPEED)
        cos, sin, stack = np.cos, np.sin, np.stack
    theta_new = pose[..., 2] + yaw_rate * dt
    mid_speed = 0.5 * (speed + speed_new)
    x = pose[..., 0] + mid_speed * cos(theta_new) * dt
    y = pose[..., 1] + mid_speed * sin(theta_new) * dt
    return stack([x, y, theta_new], -1), speed_new
