"""The wide layout's table (ops/common.py, the mirror of csrc/models.cuh):
the chains a group takes, the tile stages of the products' ring and the
dynamic shared memory a block asks for, at every D from 1 to 1024.

Held against values worked out by hand from the layout's rule (five [D][NB]
vectors, tile stages of D rounded up to 4 rows of 17 floats, three stages
where they fit, else two), against the limit a block may ask for (the
H100's 232,448 B less 8 KiB for the kernels' static arrays), and, at D <=
256, against the layout before D > 256 was added (groups of 64, 32, 16,
three stages), which must not change. tests/test_torch_cuda.py holds the
kernels' own table (the ``wide_layout`` entry) to this one on the card.
"""

import pytest

from ptmcmcsampler_torch.ops import common

H100_SMEM_PER_BLOCK = 232448
STATIC_RESERVE = 8192


def _before(d):
    """The layout at D <= 256 as it was: (NB, stages, bytes)."""
    nb = 64 if d <= 64 else (32 if d <= 128 else 16)
    stage = (-(-d // 4) * 4 * 17 + 3) & ~3
    return nb, 3, 4 * (5 * d * nb + 3 * stage)


def _layout(d):
    nb = common.wide_group(d)
    return nb, common.wide_stages(d, nb), common.wide_smem_bytes(d, nb)


# (D, NB, stages, bytes), worked out by hand: 4 (5 D NB + stages * ceil4(D) * 17).
HAND = [
    (1, 64, 3, 4 * (5 * 1 * 64 + 3 * 4 * 17)),
    (50, 64, 3, 4 * (5 * 50 * 64 + 3 * 52 * 17)),      # 74,608
    (200, 16, 3, 4 * (5 * 200 * 16 + 3 * 200 * 17)),   # 104,800
    (256, 16, 3, 134144),
    (257, 8, 3, 94160),
    (270, 8, 3, 98688),
    (300, 8, 3, 109200),
    (512, 8, 3, 186368),
    (513, 4, 3, 146304),
    (788, 4, 3, 223792),   # the last D of three stages
    (789, 4, 2, 170832),   # the first of two: three would take 224,688
    (1000, 4, 2, 216000),
    (1024, 4, 2, 221184),
]


@pytest.mark.parametrize("d,nb,stages,nbytes", HAND)
def test_layout_matches_hand_worked_values(d, nb, stages, nbytes):
    assert _layout(d) == (nb, stages, nbytes)


def test_layout_at_every_d_fits_and_follows_the_rule():
    limit = H100_SMEM_PER_BLOCK - STATIC_RESERVE
    assert common.WIDE_SMEM_LIMIT == limit and common.WIDE_MAX_D == 1024
    for d in range(1, common.WIDE_MAX_D + 1):
        nb, stages, nbytes = _layout(d)
        assert nb == (64 if d <= 64 else 32 if d <= 128 else 16 if d <= 256
                      else 8 if d <= 512 else 4), d
        # 256 threads of 4 rows and 4 chains cover D: 4096 / NB rows.
        assert 4096 // nb >= d and nb & (nb - 1) == 0
        stage = -(-d // 4) * 4 * 17
        three = 4 * (5 * d * nb + 3 * stage)
        assert stages == (3 if three <= limit else 2), d
        assert nbytes == 4 * (5 * d * nb + stages * stage) <= limit, d
        assert nbytes % 16 == 0


def test_layout_up_to_256_is_unchanged():
    for d in range(1, 257):
        assert _layout(d) == _before(d), d


def test_two_stages_only_past_788():
    two = [d for d in range(1, common.WIDE_MAX_D + 1) if _layout(d)[1] == 2]
    assert two == list(range(789, common.WIDE_MAX_D + 1))


@pytest.mark.parametrize("functor", ["correlated_gaussian", "interval_gaussian",
                                     "hierarchical_gaussian"])
@pytest.mark.parametrize("kernel", ["chees", "hmc", "nuts"])
def test_functor_table_reaches_1024(functor, kernel):
    assert common.kernel_refusal(functor, kernel, 1024) is None
    assert common.kernel_refusal(functor, kernel, 270) is None
    assert "got 1025" in common.kernel_refusal(functor, kernel, 1025)
