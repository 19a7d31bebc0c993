"""The yardstick's counts on small graphs worked out by hand."""
import torch

from benchmark import counts


def test_gather_bytes_by_hand():
    # 3 edges' 4-byte indices, 2 source rows read and 4 rows written, 8 bf16
    assert counts.gather_bytes(3, 2, 4, 8, 2) == 3 * 4 + (2 + 4) * 8 * 2


def test_epoch_flops_gcn_by_hand():
    # layer 0 (4 -> 3): forward 2*10*4*3 = 240, weight gradient 240, no
    # input gradient; forward sum 2*30*4 = 240, no backward sum
    # layer 1 (3 -> 2): 120 three times; sums 2*30*3 forward and backward
    assert counts.epoch_flops(10, 30, [(4, 3), (3, 2)], 1) == (480 + 240) + (360 + 360)


def test_epoch_flops_sage_counts_both_products():
    assert counts.epoch_flops(10, 30, [(4, 3), (3, 2)], 2) == (960 + 240) + (720 + 360)


def _set(masks, t, row, col):
    masks[t, row, col % counts.TILE_WORDS] |= 1 << (col // counts.TILE_WORDS)


def test_tile_work_by_hand():
    m = torch.zeros((3, counts.TILE_ROWS, counts.TILE_WORDS), dtype=torch.int32)
    _set(m, 0, 0, 0)
    _set(m, 0, 0, 129)
    _set(m, 0, 5, 0)        # a source row read twice counts once
    _set(m, 1, 7, 129)      # another destination block, the same window
    _set(m, 1, 9, 2047)     # bit 15: the int16 sign bit
    _set(m, 2, 0, 3)        # past `tiles`: not counted
    masks = ((m + 2 ** 15) % 2 ** 16 - 2 ** 15).to(torch.int16)  # as int16 bits
    tile_src = torch.tensor([2048, 2048, 0], dtype=torch.int32)
    edges, rows = counts.tile_work(masks, tile_src, 2, 4096, chunk=1)
    assert (edges, rows) == (5, 3)  # rows 2048, 2048 + 129, 2048 + 2047


def test_shares():
    assert counts.roofline_pct(counts.PEAK_BYTES_S * 1e-3, 2e-3) == 50.0
    assert abs(counts.mfu_pct(counts.PEAK_BF16_FLOP_S, 2.0, 4) - 12.5) < 1e-12
