"""KV quantization helpers (counterpart of ``ops/kv_quant.py``): the one
quantizer every writer of a quantized page goes through.

Quantized pages store K/V as int8 or ``float8_e4m3fn`` codes plus one
bf16 scale per (page, head, position), and the paged kernels dequantize
them as they read. Every writer — ``paged_scatter_rows`` (prefill),
``_paged_writeback`` (the gather path), the fused kernel's in-launch
scatter (``csrc/paged_attention.cu``) and its plain version — must write
the same bytes for the same rows, so the Python writers call
:func:`quantize_kv` and the CUDA kernel repeats its order of operations.

Scheme: symmetric per-(position, head) absmax scaling over the head
dimension. For a row ``x`` of shape ``(..., hd)``::

    scale = bf16(amax(|x|) / qmax)           (1.0 where amax == 0)
    q     = clip(round(x / f32(scale)), -qmax, qmax)   (int8: round half
                                                       to even; fp8: no
                                                       round, the cast
                                                       rounds to nearest)

The division uses the ROUNDED (stored) scale, so ``dequantize_kv`` gives
back exactly what every reader multiplies out. At ``hd == 64`` a K+V
position costs 2 * (64 + 2) = 132 bytes per head against bf16's 256
(:func:`kv_bytes_per_position`): 66/128 of the bf16 layout.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["quantize_kv", "dequantize_kv", "resolve_kv_dtype",
           "kv_store_dtype", "kv_qmax", "supports_fp8", "SCALE_DTYPE",
           "kv_bytes_per_position"]

#: dtype of the per-(page, head, position) scale arrays
SCALE_DTYPE = torch.bfloat16

#: accepted kv_dtype names -> canonical form (None = unquantized pages)
_CANON = {None: None, "": None, "none": None, "bf16": None,
          "bfloat16": None, "int8": "int8", "fp8": "fp8",
          "float8": "fp8", "float8_e4m3fn": "fp8", "e4m3": "fp8"}

#: symmetric clip bound per store dtype: int8 never produces -128;
#: e4m3fn's largest finite value is 448
_QMAX_INT8 = 127.0
_QMAX_FP8 = 448.0


def supports_fp8() -> bool:
    """Whether this torch build holds and converts ``float8_e4m3fn``."""
    if not hasattr(torch, "float8_e4m3fn"):
        return False
    try:
        torch.zeros(1, dtype=torch.float8_e4m3fn).float()
        return True
    except (RuntimeError, TypeError):
        return False


def resolve_kv_dtype(kv_dtype) -> Optional[str]:
    """Canonicalize a ``kv_dtype`` value to ``"int8"``, ``"fp8"`` or None
    (unquantized pages). Raises on unknown names and on ``"fp8"`` when
    the build lacks ``float8_e4m3fn``."""
    key = kv_dtype
    if isinstance(key, str):
        key = key.strip().lower()
    if key not in _CANON:
        raise ValueError(
            f"unknown kv_dtype {kv_dtype!r} (choose 'bf16', 'int8' or 'fp8')")
    canon = _CANON[key]
    if canon == "fp8" and not supports_fp8():
        raise ValueError("kv_dtype='fp8' needs torch.float8_e4m3fn, which "
                         "this torch build lacks; use kv_dtype='int8'")
    return canon


def kv_store_dtype(kv_dtype: Optional[str]):
    """The torch dtype quantized pages are stored in, or None for
    unquantized pages."""
    canon = resolve_kv_dtype(kv_dtype)
    if canon is None:
        return None
    return torch.int8 if canon == "int8" else torch.float8_e4m3fn


def kv_qmax(dtype) -> float:
    """Symmetric clip bound of a quantized store dtype."""
    if dtype == torch.int8:
        return _QMAX_INT8
    if hasattr(torch, "float8_e4m3fn") and dtype == torch.float8_e4m3fn:
        return _QMAX_FP8
    raise ValueError(f"not a quantized KV store dtype: {dtype!r}")


def quantize_kv(x: torch.Tensor, store_dtype):
    """Quantize ``x`` (..., hd) to ``(q, scale)``: ``q`` has ``x``'s shape
    in ``store_dtype``, ``scale`` drops the last axis and is
    :data:`SCALE_DTYPE`. The division uses the rounded (stored) scale."""
    qm = kv_qmax(store_dtype)
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1)
    scale = torch.where(amax > 0.0, amax / qm,
                        torch.ones_like(amax)).to(SCALE_DTYPE)
    y = xf / scale.to(torch.float32)[..., None]
    if store_dtype == torch.int8:
        q = torch.clamp(torch.round(y), -qm, qm).to(store_dtype)
    else:
        q = torch.clamp(y, -qm, qm).to(store_dtype)
    return q, scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype=torch.float32) -> torch.Tensor:
    """``f32(q) * f32(scale)`` (scale broadcast over the head dimension) in
    ``dtype`` — the product the paged kernels form after their loads. It
    is exact in f32 for int8 and e4m3 codes times a bf16 scale."""
    out = q.to(torch.float32) * scale.to(torch.float32)[..., None]
    return out.to(dtype)


def kv_bytes_per_position(heads: int, head_dim: int, value_dtype,
                          quantized: bool) -> int:
    """Device bytes one cached K+V position costs in ONE layer:
    ``2 * heads * (hd * itemsize + scale bytes)``."""
    item = torch.empty((), dtype=value_dtype).element_size()
    scale = (torch.empty((), dtype=SCALE_DTYPE).element_size()
             if quantized else 0)
    return 2 * int(heads) * (int(head_dim) * item + scale)
