"""Bit and nibble packing (port of ``repro/core/packing.py``): N:M sparsity masks
at one bit per element and int4 codes at two per byte.

Mask packing: the keep-mask is packed along d_in (axis -2 by default),
big-endian within each uint8 byte, as ``numpy.packbits`` does; the packed axis
has ``ceil(d_in / 8)`` rows and the trailing pad bits are zero, so a popcount
of the packed array is the survivor count.

int4 packing: along ``axis``, element 2r goes to the low nibble and element
2r + 1 to the high nibble of byte r; unpacking sign-extends both nibbles.
"""
from __future__ import annotations

import torch


def _shifts(device) -> torch.Tensor:
    """Bit positions of a byte, most significant first, made on ``device`` (no
    host-to-device copy, so the plain versions can be captured in a CUDA graph)."""
    return torch.arange(7, -1, -1, dtype=torch.uint8, device=device)


def pack_mask(mask: torch.Tensor, axis: int = -2) -> torch.Tensor:
    """{0,1} keep-mask → uint8, one bit per element along ``axis``."""
    m = torch.movedim((mask != 0).to(torch.uint8), axis, -1)
    n = m.shape[-1]
    pad = (-n) % 8
    if pad:
        m = torch.cat([m, m.new_zeros(m.shape[:-1] + (pad,))], dim=-1)
    m = m.reshape(m.shape[:-1] + (m.shape[-1] // 8, 8))
    packed = (m << _shifts(m.device)).sum(dim=-1, dtype=torch.uint8)
    return torch.movedim(packed, -1, axis).contiguous()


def unpack_mask(packed: torch.Tensor, count: int, axis: int = -2) -> torch.Tensor:
    """Inverse of :func:`pack_mask`: uint8 {0,1} with ``count`` rows along ``axis``
    (the pad bits are dropped)."""
    p = torch.movedim(packed.to(torch.uint8), axis, -1)
    bits = (p[..., None] >> _shifts(p.device)) & 1
    bits = bits.reshape(p.shape[:-1] + (p.shape[-1] * 8,))[..., :count]
    return torch.movedim(bits, -1, axis).contiguous()


def pack_int4(codes: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Pack int8-held int4 codes (range [-8, 7]) pairwise along ``axis``."""
    c = torch.movedim(codes.to(torch.int8), axis, -1)
    if c.shape[-1] % 2:
        raise ValueError("pack axis must be even")
    lo, hi = c[..., 0::2], c[..., 1::2]
    packed = (hi << 4) | (lo & 0x0F)
    return torch.movedim(packed.to(torch.int8), -1, axis).contiguous()


def unpack_int4(packed: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Inverse of :func:`pack_int4` (sign-extends both nibbles)."""
    p = torch.movedim(packed.to(torch.int8), axis, -1)
    lo = (p << 4) >> 4                   # int8 arithmetic shifts: sign-extended
    hi = p >> 4
    out = torch.stack([lo, hi], dim=-1).reshape(p.shape[:-1] + (p.shape[-1] * 2,))
    return torch.movedim(out, -1, axis).contiguous()
