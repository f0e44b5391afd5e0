"""The roofline arithmetic on hand-counted cases."""
import pytest
import torch

from flamebench import roofline


def test_bbox_pairs_by_hand():
    # A right triangle (0,0) (4,0) (0,3): bounding box pixels x 0..4,
    # y 0..3 = 5 x 4 = 20; an invalid triangle counts nothing; one
    # clipped at the image edge (x 8..12 in an image 10 wide: 8, 9)
    # with y 1.5..2.5 (pixel row 2 only): 2 pairs.
    pos = torch.tensor([[0.0, 0.0], [4.0, 0.0], [0.0, 3.0],
                        [8.0, 1.5], [12.0, 1.5], [8.0, 2.5]])
    tris = torch.tensor([[0, 1, 2], [0, 1, 2], [3, 4, 5]],
                        dtype=torch.int32)
    tv = torch.tensor([True, False, True])
    assert roofline.bbox_pairs(pos, tris, tv, 8, 10) == 20 + 2


def test_batched_bytes_by_hand():
    # S = 2 images of 4 x 6, T = 3: slabs 2 * 11 * 3 * 4 = 264, tile
    # ranges 2 * 2 * (4 / 2) * 4 = 32, counts 2 * 8 = 16, ids
    # 2 * 4 * 6 * 4 = 192.
    assert roofline.v4_batched_bytes(2, 3, 4, 6) == 264 + 32 + 16 + 192


def test_bound_takes_the_larger():
    pos = torch.tensor([[[0.0, 0.0], [4.0, 0.0], [0.0, 3.0]]])
    tris = torch.tensor([[[0, 1, 2]]], dtype=torch.int32)
    tv = torch.tensor([[True]])
    s, by = roofline.v4_batched_bound_s(pos, tris, tv, 4, 6)
    ops = 20 * 6 / roofline.F32_INSTR_RATE
    byt = roofline.v4_batched_bytes(1, 1, 4, 6) / roofline.PEAK_BYTES
    assert s == pytest.approx(max(ops, byt)) and by == "bytes"
    assert byt > ops
