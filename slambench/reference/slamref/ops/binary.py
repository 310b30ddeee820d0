"""Binary descriptors matched under the Hamming norm.

Counterpart of ``slam_tpu/ops/binary.py``: the reference's headline AKAZE
configuration matches binary descriptors with
``BFMatcher(NORM_HAMMING, crossCheck=True)``. Each bit is stored as a +-1
value, so

    popcount(a XOR b) = (D - <s_a, s_b>) / 2,   s = 2 bit - 1,

and kernel B2 (``cuda_kernels.mutual_nearest``) computes Hamming
distances with no change: its base distance ``2 - 2 <s_a, s_b>`` equals
``(2 - 2D) + 4 hamming``, an increasing affine map, and with +-1 inputs
every bf16 product and float32 sum is an exact integer. So every argmin
and cross-check is the popcount matcher's, ties included (lowest index,
as ``jnp.argmin``); only the gate and the reported distance are mapped.
"""

from __future__ import annotations

import numpy as np
import torch

from . import matching

DESC_BITS = 128  # one bit per float-descriptor dimension


def binarize_descriptors(desc: torch.Tensor) -> torch.Tensor:
    """(..., K, D) float descriptors -> +-1 bit signs in the same dtype:
    bit d is set iff dimension d exceeds the descriptor's own mean (an
    all-zero descriptor gives all -1)."""
    thresh = torch.mean(desc, dim=-1, keepdim=True)
    return torch.where(desc > thresh, 1.0, -1.0).to(desc.dtype)


def base_gate_from_hamming(max_hamming: float, D: int) -> float:
    """Hamming gate -> the matcher's base-distance gate. The matcher keeps
    ``dist < gate``; the half-bit offset makes ``h <= max_hamming`` pass
    and ``h = max_hamming + 1`` fail, exactly (small integers times 4)."""
    return (2.0 - 2.0 * D) + 4.0 * (float(max_hamming) + 0.5)


def hamming_from_base(dist: torch.Tensor, D: int = DESC_BITS) -> torch.Tensor:
    """Invert base = (2 - 2D) + 4 h on matched entries (BIG stays BIG)."""
    h = (dist - (2.0 - 2.0 * D)) * 0.25
    return torch.where(dist >= matching.BIG, dist, h)


def hamming_mutual_match(sbits_a, sbits_b, valid_a, valid_b,
                         max_hamming: float = DESC_BITS, xy_a=None,
                         xy_b=None, window=None) -> dict:
    """``matching.mutual_match`` on (B, K, D) +-1 signs with the distance
    gate and the reported ``dist`` in bits."""
    D = sbits_a.shape[-1]
    out = matching.mutual_match(
        sbits_a, sbits_b, valid_a, valid_b,
        max_dist=base_gate_from_hamming(max_hamming, D), xy_a=xy_a,
        xy_b=xy_b, window=window)
    return dict(out, dist=hamming_from_base(out["dist"], D))


def hamming_mutual_match_batched(sbits_a, sbits_b, valid_a, valid_b,
                                 max_hamming: float = DESC_BITS, xy_a=None,
                                 xy_b=None, window=None) -> dict:
    """:func:`hamming_mutual_match` (already batched over pairs) under the
    JAX package's name."""
    return hamming_mutual_match(sbits_a, sbits_b, valid_a, valid_b,
                                max_hamming, xy_a, xy_b, window)


def hamming_distance_matrix_ref(sbits_a: np.ndarray, sbits_b: np.ndarray
                                ) -> np.ndarray:
    """Host popcount reference for tests: (Ka, D), (Kb, D) signs ->
    (Ka, Kb) int32 Hamming distances, by XOR of the packed bits."""
    pa = np.packbits(np.asarray(sbits_a) > 0, axis=-1)
    pb = np.packbits(np.asarray(sbits_b) > 0, axis=-1)
    x = np.bitwise_xor(pa[:, None, :], pb[None, :, :])
    return np.unpackbits(x, axis=-1).sum(axis=-1).astype(np.int32)
