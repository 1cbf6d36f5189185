"""Partner permutations for rank-axis exchanges."""

from __future__ import annotations


def xor_perm(p: int, mask: int):
    """Partner permutation ``j -> j ^ mask`` (a valid permutation for any
    mask in [1, p) when p is a power of two): the reference's hypercube
    partner rule ``myid ^ 2^i`` (``Communication/src/main.cc:84``)."""
    return [(j, j ^ mask) for j in range(p)]


def shift_perm(p: int, shift: int):
    """Rotation permutation ``j -> (j + shift) % p``: the ring partner
    rule (``Communication/src/main.cc:198-221``)."""
    return [(j, (j + shift) % p) for j in range(p)]
