"""Distance computation: the PyTorch counterpart of ``hvq_tpu.ops.distance``.

Selection scores are the matmul expansion ``‖d‖² − 2·q·d`` over 128-lane
zero-padded vectors; reported distances are the direct fp32 ``Σ(q−d)²``.

Precision names keep the JAX package's meaning for the selection matmul:

* ``"highest"`` — IEEE fp32 (TF32 must be off on a CUDA device);
* ``"high"``    — the literal 3-pass bf16 split qhi·Vhi + qhi·Vlo + qlo·Vhi
  (``hvq_tpu/ops/pallas_scan.py:977-984``), error ≈ 2⁻²¹;
* ``"default"`` — one bf16 pass.

``torch.matmul`` on bf16 tensors rounds its OUTPUT to bf16, unlike JAX's
``preferred_element_type=float32``. Every bf16 operand is therefore upcast
to fp32 before the product: bf16·bf16 products are exact in fp32, so only
the summation order differs from one MXU pass.
"""

from __future__ import annotations

import torch

PRECISIONS = ("highest", "high", "default")


def require_ieee_fp32(device: torch.device | str) -> None:
    """Turn TF32 off for fp32 matmuls on a CUDA device and check it stuck.

    The fp32-plane certificate slack (``_CERT_REL_MM``) assumes error near
    2⁻²¹; TF32 keeps ~10 mantissa bits and would break it.
    """
    if torch.device(device).type != "cuda":
        return
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    _check_ieee_fp32()


def _check_ieee_fp32() -> None:
    if (
        torch.backends.cuda.matmul.allow_tf32
        or torch.get_float32_matmul_precision() != "highest"
    ):
        raise RuntimeError(
            "fp32 matmuls run in TF32 on this device; call "
            "require_ieee_fp32(device) first"
        )


def mm_nt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """fp32 ``a @ bᵀ`` over the last two dims (batched for 3-D operands) —
    refuses to run under TF32 on a CUDA device."""
    if a.is_cuda:
        _check_ieee_fp32()
    return torch.matmul(a.float(), b.float().transpose(-1, -2))


def split_bf16(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) bf16 planes of an fp32 tensor, returned as fp32 values."""
    xf = x.float()
    hi = xf.to(torch.bfloat16).float()
    lo = (xf - hi).to(torch.bfloat16).float()
    return hi, lo


def dot_nt(q: torch.Tensor, V: torch.Tensor, precision: str) -> torch.Tensor:
    """(B, Dt) fp32 q·Vᵀ at one of the three precision names; (G, B, Dt)
    for a batch of (G, B, 128) queries against (G, Dt, 128) rows."""
    if precision == "highest":
        return mm_nt(q, V)
    if precision == "high":
        qhi, qlo = split_bf16(q)
        Vhi, Vlo = split_bf16(V)
        return mm_nt(qhi, Vhi) + mm_nt(qhi, Vlo) + mm_nt(qlo, Vhi)
    if precision == "default":
        return mm_nt(
            q.to(torch.bfloat16).float(), V.to(torch.bfloat16).float()
        )
    raise ValueError(f"unknown precision {precision!r}; one of {PRECISIONS}")


def squared_norms(Vp: torch.Tensor) -> torch.Tensor:
    """Per-row ‖d‖² in fp32 (the matmul expansion's additive term)."""
    Vf = Vp.float()
    return (Vf * Vf).sum(dim=-1)


def tile_scores(
    qV: torch.Tensor,            # (B, 128) zero-padded query vectors
    V_tile: torch.Tensor,        # (Dt, 128) zero-padded database tile
    d_norms_tile: torch.Tensor,  # (Dt,) fp32 ‖d‖²
    precision: str = "highest",
) -> torch.Tensor:
    """(B, Dt) selection scores ‖d‖² − 2·q·d."""
    return d_norms_tile[None, :] - 2.0 * dot_nt(qV, V_tile, precision)


def exact_distances(
    qV: torch.Tensor,    # (B, 128) fp32
    rows: torch.Tensor,  # (B, K, 128) gathered candidate vectors
) -> torch.Tensor:
    """Direct fp32 ``Σ(q−d)²``: the refinement and .dist-faithful distance."""
    diff = rows.float() - qV[:, None, :].float()
    return (diff * diff).sum(dim=-1)
