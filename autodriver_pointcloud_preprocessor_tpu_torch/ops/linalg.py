"""Small geometric linear algebra: quaternions, SE(3), symmetric 3x3 eigen.

Port of ``autodriver_pointcloud_preprocessor_tpu/ops/linalg.py``.
``quaternion_to_matrix`` and ``se3_matrix`` build the TF graph's 4x4
transforms (scalar-last quaternions, float32). The eigensolvers: the
trigonometric closed form for the smallest eigenvalue, then the largest
cross product of two rows of (A - lambda I). Both the RANSAC refit and
the normals use it. Degenerate inputs fall back to (0, 0, 1).
``normals_from_entries`` is the reference's ``ops/normals.py
_normals_from_entries``, kept here so that the window ops and the normal
filter share it without importing each other.
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = [
    "normals_from_entries",
    "quaternion_to_matrix",
    "se3_matrix",
    "smallest_eigenvector_sym3x3",
    "smallest_eigvec_entries",
]


def quaternion_to_matrix(qx, qy, qz, qw) -> torch.Tensor:
    """Quaternion (x, y, z, w order, scipy's scalar-last convention) ->
    float32 3x3 rotation on the CPU. A quaternion of norm n is scaled by
    s = 2 / n (IEEE division), so it need not be unit; n = 0 gives the
    identity."""
    qx, qy, qz, qw = (torch.as_tensor(v, dtype=torch.float32) for v in (qx, qy, qz, qw))
    n = qx * qx + qy * qy + qz * qz + qw * qw
    s = torch.where(n > 0, torch.div(torch.tensor(2.0), n), torch.tensor(0.0))
    xx, yy, zz = qx * qx * s, qy * qy * s, qz * qz * s
    xy, xz, yz = qx * qy * s, qx * qz * s, qy * qz * s
    wx, wy, wz = qw * qx * s, qw * qy * s, qw * qz * s
    return torch.stack([
        torch.stack([1.0 - (yy + zz), xy - wz, xz + wy]),
        torch.stack([xy + wz, 1.0 - (xx + zz), yz - wx]),
        torch.stack([xz - wy, yz + wx, 1.0 - (xx + yy)]),
    ])


def se3_matrix(translation, quaternion_xyzw) -> torch.Tensor:
    """(t, q) -> homogeneous float32 4x4 on the CPU."""
    rot = quaternion_to_matrix(*quaternion_xyzw)
    t = torch.as_tensor(np.asarray(translation, np.float32)).reshape(3, 1)
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=torch.float32)
    return torch.cat([torch.cat([rot, t], dim=1), bottom], dim=0)


def _eigen_angle(a00, a11, a22, a01, a02, a12):
    """(q, p, phi) of the trigonometric closed form: the eigenvalues are
    q + 2 p cos(phi + 2 pi k / 3), the largest at k = 0, the smallest at
    k = 1."""
    q = (a00 + a11 + a22) / 3.0
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    d0, d1, d2 = a00 - q, a11 - q, a22 - q
    p2 = d0 * d0 + d1 * d1 + d2 * d2 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=0.0))
    safe_p = torch.where(p > 0, p, torch.ones_like(p))
    b00, b11, b22 = d0 / safe_p, d1 / safe_p, d2 / safe_p
    b01, b02, b12 = a01 / safe_p, a02 / safe_p, a12 / safe_p
    detb = (
        b00 * (b11 * b22 - b12 * b12)
        - b01 * (b01 * b22 - b12 * b02)
        + b02 * (b01 * b12 - b11 * b02)
    )
    r = torch.clamp(detb / 2.0, -1.0, 1.0)
    return q, p, torch.arccos(r) / 3.0


def _smallest_eigenvalue(a00, a11, a22, a01, a02, a12):
    q, p, phi = _eigen_angle(a00, a11, a22, a01, a02, a12)
    return q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0), p


def _row_cross(a00, a11, a22, a01, a02, a12, lam):
    """An eigenvector of ``lam``, unnormalised: the largest cross product
    of two rows of (A - lam I)."""
    r0x, r0y, r0z = a00 - lam, a01, a02
    r1x, r1y, r1z = a01, a11 - lam, a12
    r2x, r2y, r2z = a02, a12, a22 - lam

    def cross(ax, ay, az, bx, by, bz):
        return ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx

    c01 = cross(r0x, r0y, r0z, r1x, r1y, r1z)
    c02 = cross(r0x, r0y, r0z, r2x, r2y, r2z)
    c12 = cross(r1x, r1y, r1z, r2x, r2y, r2z)

    def norm2(c):
        return c[0] * c[0] + c[1] * c[1] + c[2] * c[2]

    n01, n02, n12 = norm2(c01), norm2(c02), norm2(c12)
    use01 = (n01 >= n02) & (n01 >= n12)
    use02 = (~use01) & (n02 >= n12)

    def pick(i):
        return torch.where(use01, c01[i], torch.where(use02, c02[i], c12[i]))

    return pick(0), pick(1), pick(2)


def smallest_eigvec_entries(a00, a11, a22, a01, a02, a12):
    """Smallest eigenvector (vx, vy, vz) from the six unique entries.

    Entries are same-shaped float32 tensors; degenerate inputs fall back to
    (0, 0, 1).
    """
    lam, p = _smallest_eigenvalue(a00, a11, a22, a01, a02, a12)
    vx, vy, vz = _row_cross(a00, a11, a22, a01, a02, a12, lam)
    nrm = torch.sqrt(torch.clamp(vx * vx + vy * vy + vz * vz, min=0.0))
    ok = (nrm > 1e-20) & (p > 0)
    safe = torch.where(nrm > 0, nrm, torch.ones_like(nrm))
    zero = torch.zeros_like(vx)
    vx = torch.where(ok, vx / safe, zero)
    vy = torch.where(ok, vy / safe, zero)
    vz = torch.where(ok, vz / safe, torch.ones_like(vz))
    return vx, vy, vz


def _off_the_line(a00, a11, a22, a01, a02, a12, nx, ny, nz):
    """The normal (nx, ny, nz) without its component along the largest
    eigenvector, where that eigenvector is the better determined of the
    two: its eigenvalue stands further from the middle one than the middle
    one from the smallest. On a line-like neighbourhood (two small
    eigenvalues) the cross products of the smallest eigenvalue's rows
    cancel in float32, and the normal can lean on the line (by up to 25
    degrees on an H100, ROADMAP fault 16), while those of the largest do
    not cancel. Elsewhere the normal is already perpendicular to that
    eigenvector, and this moves it by rounding alone."""
    q, p, phi = _eigen_angle(a00, a11, a22, a01, a02, a12)
    lam0 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    lam2 = q + 2.0 * p * torch.cos(phi)
    lam1 = 3.0 * q - lam0 - lam2
    vx, vy, vz = _row_cross(a00, a11, a22, a01, a02, a12, lam2)
    vn = torch.sqrt(vx * vx + vy * vy + vz * vz)
    vn_safe = torch.where(vn > 0, vn, torch.ones_like(vn))
    vx, vy, vz = vx / vn_safe, vy / vn_safe, vz / vn_safe
    d = nx * vx + ny * vy + nz * vz
    px, py, pz = nx - d * vx, ny - d * vy, nz - d * vz
    pn = torch.sqrt(px * px + py * py + pz * pz)
    use = (lam2 - lam1 > lam1 - lam0) & (vn > 1e-20) & (pn > 1e-3)
    pn_safe = torch.where(use, pn, torch.ones_like(pn))
    return (torch.where(use, px / pn_safe, nx), torch.where(use, py / pn_safe, ny),
            torch.where(use, pz / pn_safe, nz))


def smallest_eigenvector_sym3x3(mats: torch.Tensor):
    """Smallest eigenpair of symmetric float32[..., 3, 3] matrices.

    Returns (eigenvector float32[..., 3] unit-norm, eigenvalue float32[...]).
    """
    mats = mats.to(torch.float32)
    entries = (
        mats[..., 0, 0], mats[..., 1, 1], mats[..., 2, 2],
        mats[..., 0, 1], mats[..., 0, 2], mats[..., 1, 2],
    )
    vx, vy, vz = smallest_eigvec_entries(*entries)
    lam, _ = _smallest_eigenvalue(*entries)
    return torch.stack([vx, vy, vz], dim=-1), lam


def normals_from_entries(a00, a11, a22, a01, a02, a12, count) -> torch.Tensor:
    """float32[..., 3, N] unit normals from the six covariance entries
    (each [..., N]): the smallest eigenvector, signed so that its
    largest-magnitude component is positive; (0, 0, 1) where fewer than 3
    neighbours were counted. The normal of a line-like neighbourhood is
    taken off the line (``_off_the_line``), where the reference's leans on
    it."""
    nx, ny, nz = smallest_eigvec_entries(a00, a11, a22, a01, a02, a12)
    nx, ny, nz = _off_the_line(a00, a11, a22, a01, a02, a12, nx, ny, nz)
    ax, ay, az = torch.abs(nx), torch.abs(ny), torch.abs(nz)
    lead = torch.where((ax >= ay) & (ax >= az), nx, torch.where(ay >= az, ny, nz))
    flip = torch.where(lead < 0, -1.0, 1.0)
    nx, ny, nz = nx * flip, ny * flip, nz * flip
    ok = count >= 3
    zero = torch.zeros_like(nx)
    return torch.stack([
        torch.where(ok, nx, zero),
        torch.where(ok, ny, zero),
        torch.where(ok, nz, torch.ones_like(nz)),
    ], dim=-2)
