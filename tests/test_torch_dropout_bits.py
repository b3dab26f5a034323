"""The attention kernels' dropout bit function, on the CPU.

``dropout_keep_mask_plain`` is the bit function of
``toist_tpu_torch/csrc/attn_dropout.cuh`` in numpy; on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 6) the kernels' own
mask is held to it bit for bit. Here it is held to a scalar version in
Python integers and to the properties dropout needs: the kept share
1 - q/256, neighbours that keep independently of each other (along keys,
along queries, inside the 2x2 block that shares a hash word, the two rows
of an mma fragment, across batch*head), bits that depend on the element's
indices alone and not on the extent of the call that computes them, and
one mask per seed.

Tolerances: at 2 x 8 x 512 x 512 = 4.2M elements one binomial standard
deviation of the kept share is 1.5e-4 (q = 26) and 2.4e-4 (q = 128), so
1e-3 is over 4 of them; a joint keep rate of two neighbours has at most
2.4e-4 too, and 2e-3 leaves room for the 1/256 steps of the byte.
"""
import numpy as np
import pytest
import torch

from toist_tpu_torch.ops.flash_attention import (drop_threshold,
                                                 dropout_keep_mask_plain)

B, H, SQ, S = 2, 8, 512, 512
SEED = 20240517
RATES = {26: 26 / 256, 128: 128 / 256}
M64, M32 = 2 ** 64 - 1, 2 ** 32 - 1


@pytest.fixture(scope="module")
def masks():
    """{q: keep mask [B*H, Sq, S] as 0/1 floats} for both thresholds."""
    return {q: dropout_keep_mask_plain(SEED, B, H, SQ, S, rate).numpy()
            .reshape(B * H, SQ, S).astype(np.float64)
            for q, rate in RATES.items()}


def _scalar_keep(seed, bh, row, col, q):
    """One element's keep bit from the hash's definition in Python ints."""
    def mix64(z):
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & M64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & M64
        return z ^ (z >> 31)

    def mix32(h):
        h = ((h ^ (h >> 16)) * 0x85EBCA6B) & M32
        h = ((h ^ (h >> 13)) * 0xC2B2AE35) & M32
        return h ^ (h >> 16)

    base = mix64((seed + 0x9E3779B97F4A7C15 * (bh + 1)) & M64)
    key = mix64((base + row // 2) & M64)
    word = mix32((key & M32) ^ ((col // 2) * 0x9E3779B9 & M32))
    return (word >> (((row & 1) * 2 + (col & 1)) * 8)) & 0xFF >= q


def test_plain_mask_equals_the_scalar_definition(masks):
    rng = np.random.default_rng(0)
    keep = masks[26]
    for bh, row, col in zip(rng.integers(0, B * H, 200),
                            rng.integers(0, SQ, 200),
                            rng.integers(0, S, 200)):
        assert keep[bh, row, col] == _scalar_keep(SEED, int(bh), int(row),
                                                  int(col), 26)


@pytest.mark.parametrize("q", sorted(RATES))
def test_kept_share(masks, q):
    assert drop_threshold(RATES[q]) == q
    share = masks[q].mean()
    assert abs(share - (1 - q / 256)) < 1e-3, share


def _neighbours(k, kind):
    """Pairs of elements that a weak hash would couple."""
    return {
        "keys": (k[:, :, :-1], k[:, :, 1:]),
        "queries": (k[:, :-1], k[:, 1:]),
        "block_diagonal": (k[:, 0::2, 0::2], k[:, 1::2, 1::2]),
        "block_antidiagonal": (k[:, 0::2, 1::2], k[:, 1::2, 0::2]),
        "fragment_rows": (k[:, :-8], k[:, 8:]),
        "batch_heads": (k[:-1], k[1:]),
    }[kind]


@pytest.mark.parametrize("kind", ["keys", "queries", "block_diagonal",
                                  "block_antidiagonal", "fragment_rows",
                                  "batch_heads"])
@pytest.mark.parametrize("q", sorted(RATES))
def test_neighbours_keep_independently(masks, q, kind):
    a, b = _neighbours(masks[q], kind)
    p = 1 - q / 256
    joint = (a * b).mean()
    assert abs(joint - p * p) < 2e-3, (joint, p * p)


@pytest.mark.parametrize("b,sq,s", [(1, 37, 70), (2, 101, 512),
                                    (1, 512, 3)])
def test_sub_block_alone_equals_the_slice(masks, b, sq, s):
    """The bits of an element depend on (seed, bh, row, col) alone: the
    mask of a smaller call (odd extents included) is the leading slice of
    the whole mask, as a kernel's tile regenerates the bits it needs."""
    alone = dropout_keep_mask_plain(SEED, b, H, sq, s, RATES[26]).numpy()
    whole = masks[26].reshape(B, H, SQ, S)
    np.testing.assert_array_equal(alone, whole[:b, :, :sq, :s] != 0)


def test_one_mask_per_seed():
    a = dropout_keep_mask_plain(7, 2, 2, 64, 96, 0.1)
    b = dropout_keep_mask_plain(7, 2, 2, 64, 96, 0.1)
    c = dropout_keep_mask_plain(8, 2, 2, 64, 96, 0.1)
    assert a.dtype == torch.bool and a.shape == (2, 2, 64, 96)
    assert (a == b).all() and not (a == c).all()
    # Seeds that differ only in high bits differ too (a 64-bit seed).
    d = dropout_keep_mask_plain(7 + 2 ** 40, 2, 2, 64, 96, 0.1)
    assert not (a == d).all()
    with pytest.raises(ValueError):
        dropout_keep_mask_plain(7, 2, 2, 64, 96, 0.0)
