"""Polar <-> Cartesian conversions for DOA labels.

Parity: feature_extractor.py:238-271 (numpy, degrees in azimuth/elevation).
"""
from __future__ import annotations

import numpy as np

from seld_tpu_torch.utils.common import degree_to_radian, radian_to_degree


def cartesian_to_polar(coordinates) -> np.ndarray:
    """[..., 3] xyz -> [..., 3] (azimuth deg, elevation deg, r)."""
    coordinates = np.asarray(coordinates)
    if coordinates.shape[-1] != 3:
        raise ValueError("only 3D cartesian coordinates are allowed")

    x = coordinates[..., 0]
    y = coordinates[..., 1]
    z = coordinates[..., 2]

    azimuth = radian_to_degree(np.arctan2(y, x))
    elevation = radian_to_degree(np.arctan2(z, np.sqrt(x ** 2 + y ** 2)))
    r = np.sqrt(x ** 2 + y ** 2 + z ** 2)
    return np.stack([azimuth, elevation, r], axis=-1)


def polar_to_cartesian(coordinates) -> np.ndarray:
    """[..., 2|3] (azimuth deg, elevation deg[, r]) -> [..., 3] xyz."""
    coordinates = np.asarray(coordinates)
    azimuth = degree_to_radian(coordinates[..., 0])
    elevation = degree_to_radian(coordinates[..., 1])
    r = coordinates[..., 2] if coordinates.shape[-1] == 3 else 1

    x = r * np.cos(azimuth) * np.cos(elevation)
    y = r * np.sin(azimuth) * np.cos(elevation)
    z = r * np.sin(elevation)
    return np.stack([x, y, z], axis=-1)
