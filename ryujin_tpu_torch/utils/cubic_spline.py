"""Natural cubic spline interpolation (ryujin_tpu/utils/cubic_spline.py,
the analog of the reference's GSL wrapper cubic_spline.h), numpy only:
the port evaluates it on the host, where the airfoil generator samples
its profiles.
"""

from __future__ import annotations

import numpy as np


class CubicSpline:
    """Natural cubic spline through (x_i, y_i); x strictly increasing."""

    def __init__(self, x: np.ndarray, y: np.ndarray):
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64)
        if x.ndim != 1 or x.shape != y.shape or len(x) < 2:
            raise ValueError("need matching 1D arrays with >= 2 points")
        if not np.all(np.diff(x) > 0):
            raise ValueError("x must be strictly increasing")
        n = len(x)
        h = np.diff(x)
        # solve the tridiagonal system for the second derivatives (natural
        # boundary conditions M_0 = M_{n-1} = 0):
        M = np.zeros(n)
        if n > 2:
            dl = h[:-1].copy()
            dd = 2.0 * (h[:-1] + h[1:])
            du = h[1:].copy()
            rhs = 6.0 * np.diff(np.diff(y) / h)
            # Thomas algorithm
            for i in range(1, n - 2):
                w = dl[i] / dd[i - 1]
                dd[i] -= w * du[i - 1]
                rhs[i] -= w * rhs[i - 1]
            Mi = np.zeros(n - 2)
            Mi[-1] = rhs[-1] / dd[-1]
            for i in range(n - 4, -1, -1):
                Mi[i] = (rhs[i] - du[i] * Mi[i + 1]) / dd[i]
            M[1:-1] = Mi
        self.x, self.y, self.h, self.M = x, y, h, M

    def __call__(self, xq):
        """Evaluate the spline (clamps to the data range)."""
        x, y, h, M = self.x, self.y, self.h, self.M
        xq = np.clip(xq, self.x[0], self.x[-1])
        i = np.clip(np.searchsorted(x, xq, side="right") - 1,
                    0, len(self.x) - 2)
        dx = xq - x[i]
        dxr = x[i + 1] - xq
        hi = h[i]
        return (
            M[i] * dxr**3 / (6.0 * hi)
            + M[i + 1] * dx**3 / (6.0 * hi)
            + (y[i] / hi - M[i] * hi / 6.0) * dxr
            + (y[i + 1] / hi - M[i + 1] * hi / 6.0) * dx
        )

    def derivative(self, xq):
        x, y, h, M = self.x, self.y, self.h, self.M
        xq = np.clip(xq, self.x[0], self.x[-1])
        i = np.clip(np.searchsorted(x, xq, side="right") - 1,
                    0, len(self.x) - 2)
        dx = xq - x[i]
        dxr = x[i + 1] - xq
        hi = h[i]
        return (
            -M[i] * dxr**2 / (2.0 * hi)
            + M[i + 1] * dx**2 / (2.0 * hi)
            - (y[i] / hi - M[i] * hi / 6.0)
            + (y[i + 1] / hi - M[i + 1] * hi / 6.0)
        )
