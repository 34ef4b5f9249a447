"""Schur-complement block inversion (port of
``bayesianinference_tpu.core.linalg``): a block of a matrix inverse
without forming the full inverse."""

from __future__ import annotations

import torch

from .numerics import as_float

__all__ = ["matrix_block_inverse", "inverse_matrix_block_inverse"]


def _split(mat: torch.Tensor, cols):
    cols = torch.as_tensor(cols, device=mat.device).reshape(-1)
    mask = torch.zeros(mat.shape[-1], dtype=torch.bool, device=mat.device)
    mask[cols] = True
    return cols, torch.nonzero(~mask).reshape(-1)


def inverse_matrix_block_inverse(mat, cols) -> torch.Tensor:
    """Inverse[Inverse[mat][[cols, cols]]]: the Schur complement
    ``M_cc - M_cr M_rr^-1 M_rc``."""
    mat = as_float(mat)
    cols, rest = _split(mat, cols)
    m_cc = mat[cols][:, cols]
    m_cr = mat[cols][:, rest]
    m_rc = mat[rest][:, cols]
    m_rr = mat[rest][:, rest]
    return m_cc - m_cr @ torch.linalg.solve(m_rr, m_rc)


def matrix_block_inverse(mat, cols) -> torch.Tensor:
    """Inverse[mat][[cols, cols]] without the full inverse."""
    return torch.linalg.inv(inverse_matrix_block_inverse(mat, cols))
