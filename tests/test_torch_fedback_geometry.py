"""The launch geometry of the K1 and K3 kernels, checked without a card.

``trigger_norms.trigger_segments`` / ``check_kernel_args`` choose how
the CUDA trigger kernel splits each row into segments (one
thread-block cluster per row), and ``fused_gss.fused_gss_geometry`` /
``check_kernel_args`` size the fused commit's grid and tiles; the
wrappers pass what they return to the C launchers.  Here they are
called directly, and the tiles and segments they describe are walked
the way the kernels walk them (``csrc/fedback_kernels.cu``): every
element must be covered exactly once, K1's split must depend on D
alone, and what the kernels refuse must raise.
"""
import numpy as np
import pytest

from repro_torch.kernels import fused_gss as fg
from repro_torch.kernels import trigger_norms as tn

# The fused commit's kernel loads this many tiles before storing them
# (kGssTilesPerStep in csrc/fedback_kernels.cu).
TILES_PER_STEP = 2
# D values: tiny, one group, ragged tails of 1–3 elements, one
# segment's worth and just past it, several segments with a ragged last
# one, the paper-MNIST width (D = 159,010 = 2 mod 4), and a wide row.
DIMS = [1, 3, 4, 5, 130, 1001, 8191, 8192, 8193, 8 * 4096 + 6, 65537,
        159010, 159011, 10**7 + 3]


def _segments(d):
    """Element ranges [start, end) of each cluster block of a row, as the
    kernel takes them: the groups of 4 [r·G, (r+1)·G) ∩ [0, d // 4), and
    the last block also the tail [4·(d // 4), d)."""
    segs, g = tn.trigger_segments(d)
    groups = d // 4
    out = []
    for r in range(segs):
        g0 = min(r * g, groups)
        g1 = min(g0 + g, groups)
        out.append([(4 * g0, 4 * g1)])
    out[-1].append((4 * groups, d))
    return out


@pytest.mark.parametrize("d", DIMS)
def test_trigger_segments_cover_the_row_once_at_multiples_of_4(d):
    covered = np.zeros(d, dtype=np.int8)
    segs = _segments(d)
    assert 1 <= len(segs) <= tn.MAX_SEGMENTS
    for r, parts in enumerate(segs):
        start, end = parts[0]
        assert start % 4 == 0 and end % 4 == 0
        # a block that is not the only one always has groups to sum
        assert end > start or len(segs) == 1
        for a, b in parts:
            covered[a:b] += 1
    assert (covered == 1).all()


@pytest.mark.parametrize("d", DIMS)
def test_trigger_segments_depend_on_d_alone(d):
    want = tn.trigger_segments(d)
    for n in (1, 7, 100, 4096):
        for ptr in (0x7f0000000000, 0x7f0000000004, 0x7f0000000008):
            segs, seg_groups, _ = tn.check_kernel_args(n, d, ptr)
            assert (segs, seg_groups) == want


def test_trigger_paper_width_fills_the_card():
    """N = 100 rows of D = 159,010 make 800 blocks (> 132 SMs)."""
    segs, seg_groups = tn.trigger_segments(159010)
    assert segs == tn.MAX_SEGMENTS == 8
    assert seg_groups == -(-(159010 // 4) // 8)
    assert 100 * segs >= 6 * 132


@pytest.mark.parametrize("offset,w_vec", [(0, 4), (16, 4), (4, 1), (8, 1),
                                          (12, 1)])
def test_trigger_omega_vector_width_follows_its_alignment(offset, w_vec):
    assert tn.check_kernel_args(3, 1001, 0x7f0000000000 + offset)[2] == w_vec


@pytest.mark.parametrize("n,d,match", [
    (0, 10, "n must be"), (3, 0, "d must be"),
    (2**31 // 8, 159010, "exceed the grid")])
def test_trigger_refuses(n, d, match):
    with pytest.raises(ValueError, match=match):
        tn.check_kernel_args(n, d, 0)


def _walk_tiles(c, d, sms):
    """How many times the kernel's blocks visit each tile: block b takes
    t0 = b, b + S·grid, ... and in each step the tiles t0 + i·grid for
    i < S (S = TILES_PER_STEP), those below C·T."""
    grid, tps = fg.fused_gss_geometry(c, d, sms)
    tiles = c * tps
    seen = np.zeros(tiles, dtype=np.int64)
    per_block = np.zeros(grid, dtype=np.int64)
    step = TILES_PER_STEP * grid
    for b in range(grid):
        for t0 in range(b, tiles, step):
            for i in range(TILES_PER_STEP):
                t = t0 + i * grid
                if t < tiles:
                    seen[t] += 1
                    per_block[b] += 1
    return grid, tps, seen, per_block


def _tile_columns(j0, vec):
    """The columns the kernel's 256 threads write in the tile at column
    j0: 4 each, as float2 pairs 2·(u·256 + t) + {0, 1} or as scalars
    u·256 + t, u < 4 / vec."""
    threads = fg.TILE_COLS // 4
    t = np.arange(threads)
    if vec == 2:
        pairs = np.concatenate([u * threads + t for u in range(2)])
        return j0 + np.concatenate([2 * pairs, 2 * pairs + 1])
    return j0 + np.concatenate([u * threads + t for u in range(4)])


@pytest.mark.parametrize("c,d,sms", [
    (16, 159010, 132),   # the round: C = 16 slots at the paper width
    (1, 159010, 132),    # C = 1
    (7, 159010, 132),    # C not a divisor of the block count
    (16, 159011, 132),   # odd D
    (3, 1001, 132),      # fewer tiles than blocks on the card
    (5, 2050, 1), (40, 130, 2), (1, 1, 132)])
def test_fused_gss_tiles_cover_each_slot_and_column_once(c, d, sms):
    grid, tps, seen, per_block = _walk_tiles(c, d, sms)
    assert (seen == 1).all()
    assert (per_block >= 1).all()  # no block launches only to exit
    assert grid <= sms * fg.BLOCKS_PER_SM
    assert tps * fg.TILE_COLS >= d > (tps - 1) * fg.TILE_COLS
    for vec in ((1, 2) if d % 2 == 0 else (1,)):
        cols = np.zeros(d, dtype=np.int64)
        for chunk in range(tps):
            j = _tile_columns(chunk * fg.TILE_COLS, vec)
            np.add.at(cols, j[j < d], 1)
        assert (cols == 1).all()


def test_fused_gss_grid_fills_the_card_at_the_round():
    grid, tps = fg.fused_gss_geometry(16, 159010, 132)
    assert (grid, tps) == (132 * fg.BLOCKS_PER_SM, 156)


@pytest.mark.parametrize("d,offsets,vec", [
    (159010, (0, 0, 0, 0, 0), 2),       # even D, aligned: float2
    (159010, (0, 8, 16, 24, 40), 2),    # 8-byte steps are enough
    (159010, (0, 0, 4, 0, 0), 1),       # one base off 8 bytes
    (159010, (0, 0, 0, 0, 12), 1),
    (159011, (0, 0, 0, 0, 0), 1),       # odd D: odd rows off 8 bytes
    (1001, (0, 0, 0, 0), 1)])
def test_fused_gss_vector_width_is_picked_per_launch(d, offsets, vec):
    ptrs = tuple(0x7f0000000000 + 0x100000 * i + o
                 for i, o in enumerate(offsets))
    got = fg.check_kernel_args(4, d, 132, ptrs)
    assert got == (*fg.fused_gss_geometry(4, d, 132), vec)


@pytest.mark.parametrize("c,d,sms,match", [
    (0, 10, 132, "must be >= 1"), (4, 0, 132, "must be >= 1"),
    (4, 10, 0, "must be >= 1"), (2**31 // 100, 159010, 132, "exceed")])
def test_fused_gss_refuses(c, d, sms, match):
    with pytest.raises(ValueError, match=match):
        fg.check_kernel_args(c, d, sms, (0,) * 5)
