"""Behavioral model of the weight-embedded P²M pixel (paper §3.1, Fig. 3).

Port of `repro.core.pixel_model`.  The fit stays in numpy, so the
coefficients are bit-identical to the reference's; only
:meth:`PixelModel.__call__` evaluates ``g(w, x)`` on tensors.

``g(w, x) = Σ_{i=1..dw, j=1..dx} a_ij · w^i · x^j`` — terms with ``i = 0``
or ``j = 0`` are excluded by construction (``g(0, x) = g(w, 0) = 0``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

# Operating ranges (normalized units) of transistor driving strength and
# photodiode current.
W_RANGE = (0.0, 1.0)
X_RANGE = (0.0, 1.0)


def spice_surrogate(w, x, *, v_max: float = 1.0, sat: float = 0.55,
                    sf_leak: float = 0.02):
    """Stand-in for the SPICE-simulated pixel transfer surface (Fig. 3):
    ``v_max·(1+sat)·u/(1+sat·u)`` with ``u = w·x``, plus a small
    source-follower leakage ``sf_leak·x·w·(1−x)``."""
    u = w * x
    main = v_max * (1.0 + sat) * u / (1.0 + sat * u)
    return main + sf_leak * x * w * (1.0 - x)


@dataclasses.dataclass(frozen=True)
class PixelModel:
    """Fitted polynomial pixel model ``g(w,x) = Σ a_ij w^i x^j`` (i,j ≥ 1).

    ``coeffs[i-1, j-1]`` multiplies ``w^i x^j``.
    """

    coeffs: np.ndarray
    fit_rmse: float = 0.0
    read_noise_std: float = 0.0

    @property
    def degree_w(self) -> int:
        return self.coeffs.shape[0]

    @property
    def degree_x(self) -> int:
        return self.coeffs.shape[1]

    def __call__(self, w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """Evaluate ``g(w, x)`` elementwise (broadcasting) on tensors."""
        w = torch.as_tensor(w)
        x = torch.as_tensor(x)
        dtype = torch.promote_types(torch.promote_types(w.dtype, x.dtype),
                                    torch.float32)
        coeffs = torch.as_tensor(self.coeffs, dtype=dtype, device=w.device)
        # Horner in x inside Horner in w: g = Σ_i w^i (Σ_j a_ij x^j)
        acc = torch.zeros(torch.broadcast_shapes(w.shape, x.shape),
                          dtype=dtype, device=w.device)
        for i in range(self.degree_w, 0, -1):
            inner = torch.zeros_like(acc)
            for j in range(self.degree_x, 0, -1):
                inner = (inner + coeffs[i - 1, j - 1]) * x
            acc = (acc + inner) * w if i > 1 else acc * w + inner * w
        return acc

    def term(self, i: int, j: int) -> float:
        """Coefficient of ``w^i x^j`` (1-indexed powers)."""
        return float(self.coeffs[i - 1, j - 1])


def _design_matrix(w: np.ndarray, x: np.ndarray, dw: int, dx: int) -> np.ndarray:
    cols = [np.power(w, i) * np.power(x, j)
            for i in range(1, dw + 1) for j in range(1, dx + 1)]
    return np.stack(cols, axis=-1)


def fit_pixel_model(
    samples_w: np.ndarray | None = None,
    samples_x: np.ndarray | None = None,
    samples_v: np.ndarray | None = None,
    *,
    degree_w: int = 3,
    degree_x: int = 3,
    grid: int = 64,
    read_noise_std: float = 0.0,
    term_mask: np.ndarray | None = None,
) -> PixelModel:
    """Least-squares fit of the polynomial pixel model (numpy, as in the
    reference).  With no sample arrays, fits :func:`spice_surrogate` on a
    ``grid × grid`` sweep; ``term_mask`` (dw, dx) bool keeps only the
    selected basis terms (masked coefficients are exactly 0)."""
    if samples_v is None:
        ws = np.linspace(W_RANGE[0], W_RANGE[1], grid)
        xs = np.linspace(X_RANGE[0], X_RANGE[1], grid)
        wg, xg = np.meshgrid(ws, xs, indexing="ij")
        samples_w, samples_x = wg.ravel(), xg.ravel()
        samples_v = np.asarray(spice_surrogate(samples_w, samples_x))
    samples_w = np.asarray(samples_w, dtype=np.float64)
    samples_x = np.asarray(samples_x, dtype=np.float64)
    samples_v = np.asarray(samples_v, dtype=np.float64)

    A = _design_matrix(samples_w, samples_x, degree_w, degree_x)
    if term_mask is not None:
        mask = np.asarray(term_mask, bool).reshape(-1)
        if mask.shape[0] != A.shape[1]:
            raise ValueError(f"term_mask has {mask.shape[0]} entries, "
                             f"expected {A.shape[1]}")
        sel = np.where(mask)[0]
        coef_sel, _, _, _ = np.linalg.lstsq(A[:, sel], samples_v, rcond=None)
        coef = np.zeros(A.shape[1])
        coef[sel] = coef_sel
    else:
        coef, _, _, _ = np.linalg.lstsq(A, samples_v, rcond=None)
    resid = A @ coef - samples_v
    rmse = float(np.sqrt(np.mean(resid**2)))
    coeffs = coef.reshape(degree_w, degree_x)
    return PixelModel(coeffs=coeffs, fit_rmse=rmse,
                      read_noise_std=read_noise_std)


_DEFAULT: PixelModel | None = None


def default_pixel_model() -> PixelModel:
    """The default fitted model (22 nm GF surrogate), fit once per process."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = fit_pixel_model()
    return _DEFAULT


def linear_pixel_model() -> PixelModel:
    """Ideal multiplier ``g(w,x) = w·x`` — the 'no non-ideality' ablation."""
    return PixelModel(coeffs=np.ones((1, 1)), fit_rmse=0.0)
