"""Integer products of the executing int8 artifact: int8 x int8 -> int32.

They stand in for the JAX package's
``lax.conv_general_dilated(int8, int8, preferred_element_type=int32)``
and int8 ``dot_general`` (``models/quantization.py:100-121``), which XLA
computes outside any Pallas kernel; here a library product serves.

- The card path: im2col with strided views (padding, then
  ``Tensor.unfold`` per spatial axis, dilation by slicing), then
  ``torch._int_mm``, one product per group. ``_int_mm`` on CUDA wants
  more than 16 rows, inner and outer sizes that are multiples of 8 and a
  column-major right operand; on the H100 cuBLASLt also refuses some
  products of many rows whose outer size is 8 modulo 16 (the edge shapes
  of ``chip_smoke.py`` show it), so the outer size is padded to a
  multiple of 16.
  The operands are padded with zeros, which add nothing to an integer
  sum, and the right one is passed as the transpose of a row-major
  (out, K) matrix.
- The plain path: ``F.conv2d`` / ``F.linear`` in float64 on the
  int8-valued tensors, rounded to int32. It is exact: every partial sum
  is an integer below 127 * 127 * K < 3.0e8 (K = 18432 for the largest
  contraction of these models, ASPP's 3x3 on 2048 channels), far below
  2^53.

A tensor on the CPU takes the plain path; a CUDA tensor takes the card
path, and nothing falls back from it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["int8_conv2d", "int8_linear", "int8_conv2d_plain",
           "int8_linear_plain", "int8_conv2d_card", "int8_linear_card"]


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _check(x, w):
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"int8 operands expected, got {x.dtype} and "
                        f"{w.dtype}")
    if x.device != w.device:
        raise ValueError(f"operands on {x.device} and {w.device}")


def int8_conv2d_plain(xq, w8, stride=1, padding=0, dilation=1, groups=1):
    """(N, C, H, W) int8 * (O, C / groups, kh, kw) int8 -> (N, O, H', W')
    int32, by float64 convolution (exact)."""
    _check(xq, w8)
    y = F.conv2d(xq.double(), w8.double(), None, _pair(stride),
                 _pair(padding), _pair(dilation), groups)
    return torch.round(y).to(torch.int32)


def int8_linear_plain(xq, w8):
    """(..., K) int8 * (O, K) int8 -> (..., O) int32, in float64."""
    _check(xq, w8)
    return torch.round(F.linear(xq.double(), w8.double())).to(torch.int32)


def _round_up(n, m):
    return -(-n // m) * m


def _int_mm(a, b_t):
    """a (M, K) int8 @ b_t.T (b_t: (N, K) int8) -> (M, N) int32 with
    ``torch._int_mm``, zero-padded to its constraints."""
    m, k = a.shape
    n = b_t.shape[0]
    mp, kp, np_ = max(m, 17), _round_up(k, 8), _round_up(n, 16)
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (np_, kp) != (n, k):
        b_t = F.pad(b_t, (0, kp - k, 0, np_ - n))
    out = torch._int_mm(a.contiguous(), b_t.contiguous().t())
    return out[:m, :n]


def _im2col(xq, kernel, stride, padding, dilation):
    """(N, C, H, W) -> (N, H', W', C, kh, kw) int8 patches, from views."""
    (kh, kw), (sh, sw), (ph, pw), (dh, dw) = kernel, stride, padding, \
        dilation
    if ph or pw:
        xq = F.pad(xq, (pw, pw, ph, ph))
    span_h, span_w = (kh - 1) * dh + 1, (kw - 1) * dw + 1
    cols = xq.unfold(2, span_h, sh).unfold(3, span_w, sw)
    # (N, C, H', W', span_h, span_w) -> taps at the dilation
    cols = cols[..., ::dh, ::dw]
    return cols.permute(0, 2, 3, 1, 4, 5)


def int8_conv2d_card(xq, w8, stride=1, padding=0, dilation=1, groups=1):
    """The card path of ``int8_conv2d`` (im2col + ``torch._int_mm``)."""
    _check(xq, w8)
    n, c, _, _ = xq.shape
    o, cg, kh, kw = w8.shape
    cols = _im2col(xq, (kh, kw), _pair(stride), _pair(padding),
                   _pair(dilation))
    _, oh, ow = cols.shape[:3]
    og = o // groups
    outs = []
    for g in range(groups):
        a = cols[:, :, :, g * cg:(g + 1) * cg].reshape(n * oh * ow,
                                                     cg * kh * kw)
        b_t = w8[g * og:(g + 1) * og].reshape(og, cg * kh * kw)
        outs.append(_int_mm(a, b_t))
    y = outs[0] if groups == 1 else torch.cat(outs, dim=1)
    return y.reshape(n, oh, ow, o).permute(0, 3, 1, 2).contiguous()


def int8_linear_card(xq, w8):
    """The card path of ``int8_linear``."""
    _check(xq, w8)
    lead = xq.shape[:-1]
    y = _int_mm(xq.reshape(-1, xq.shape[-1]), w8)
    return y.reshape(*lead, w8.shape[0])


def int8_conv2d(xq, w8, stride=1, padding=0, dilation=1, groups=1):
    """int8 convolution with int32 sums: the card path for CUDA tensors,
    the plain path for CPU tensors. Arguments as ``F.conv2d``'s (integer
    padding only)."""
    if xq.is_cuda:
        return int8_conv2d_card(xq, w8, stride, padding, dilation, groups)
    return int8_conv2d_plain(xq, w8, stride, padding, dilation, groups)


def int8_linear(xq, w8):
    """int8 x int8 -> int32 product over the last axis (``F.linear``
    without a bias): the card path for CUDA tensors, the plain path for
    CPU tensors."""
    if xq.is_cuda:
        return int8_linear_card(xq, w8)
    return int8_linear_plain(xq, w8)
