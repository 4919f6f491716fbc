"""Hamming distance between packed 256-bit ORB descriptors (port of
coslam_tpu/ops/hamming.py).

  * `pairwise_hamming`      — SWAR popcount of XOR over all (N, M) pairs.
  * `pairwise_hamming_pm1`  — the same distances as a matmul of +/-1
                              unpacked descriptors: ham = (256 - A B^T) / 2,
                              exact in float32 (sums of 256 +/-1 terms).

Descriptors are (N, 8) int32 tensors holding the reference's uint32 bits
(torch supports few uint32 ops).  The popcount runs in int64 on the
zero-extended words: int32 right shifts are arithmetic and the SWAR
multiply overflows 32 bits.
"""

from __future__ import annotations

import torch

_M1 = 0x55555555
_M2 = 0x33333333
_M4 = 0x0F0F0F0F
_H01 = 0x01010101


def popcount_u32(x: torch.Tensor) -> torch.Tensor:
    """SWAR population count of 32-bit words (int32 or int64, any shape)."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & _M1)
    x = (x & _M2) + ((x >> 2) & _M2)
    x = (x + (x >> 4)) & _M4
    return (((x * _H01) >> 24) & 0xFF).to(torch.int32)


def pairwise_hamming(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """(N, 8) x (M, 8) -> (N, M) int32 Hamming distances."""
    x = desc_a[:, None, :] ^ desc_b[None, :, :]
    return popcount_u32(x).sum(-1, dtype=torch.int32)


def unpack_pm1(desc: torch.Tensor) -> torch.Tensor:
    """(N, 8) 32-bit words -> (N, 256) float32 in {-1, +1} (bit=1 -> +1)."""
    shifts = torch.arange(32, dtype=torch.int32, device=desc.device)
    bits = (desc.to(torch.int32)[:, :, None] >> shifts) & 1
    return bits.reshape(desc.shape[0], 32 * desc.shape[1]) \
        .to(torch.float32) * 2.0 - 1.0


def pairwise_hamming_pm1(desc_a: torch.Tensor,
                         desc_b: torch.Tensor) -> torch.Tensor:
    """(N, 8) x (M, 8) -> (N, M) int32, bit-identical to
    `pairwise_hamming` (the reference's `pairwise_hamming_mxu`)."""
    dot = unpack_pm1(desc_a) @ unpack_pm1(desc_b).T
    return ((256.0 - dot) * 0.5).to(torch.int32)
