"""The reference's pair counts, and the work and bounds counted from
them, on scenes small enough to count by hand."""

import pytest
import torch

from gsbench import counts, peaks
from gsbench.reference import render as R


def one_tile(rows):
    """Composite rows (m, 10) as the list of the single tile of a 128 x 16
    frame -> (acc (16, 128, 5), live pairs) at exit 1e-3 and 1e-5."""
    table = torch.cat([torch.tensor(rows, dtype=torch.float32),
                       torch.tensor([[0, 0, 1, 0, 1, 0, 0, 0, 0, 0.0]])])
    m = len(rows)
    slots = torch.full((1, 2048), m, dtype=torch.long)
    slots[0, :m] = torch.arange(m)
    cnt = torch.tensor([m])
    return [R.composite_frame(table, slots, cnt, 128, 16, exit_t=e)
            for e in (1e-3, 1e-5)]


def disc(op=0.5):
    # A unit-sigma splat at the pixel centre (64.5, 8.5): live where
    # op exp(-(dx^2 + dy^2) / 2) >= 1e-5, i.e. dx^2 + dy^2 <= 21.64 at
    # op 0.5: the integer points of that disc, 9 + 2 (9 + 9 + 7 + 5) = 69.
    return [64.5, 8.5, 1.0, 0.0, 1.0, op, 1.0, 0.5, 0.25, 3.0]


def test_one_splat_counts_its_disc():
    (acc, pairs), (_, pairs_low) = one_tile([disc()])
    assert pairs == pairs_low == 69
    assert acc[8, 64, 0] == pytest.approx(0.5)      # T a r at the centre
    assert acc[8, 64, 3] == pytest.approx(0.5)      # alpha


def test_exit_stops_the_count_behind_an_opaque_splat():
    # A front splat of alpha 0.9999 over the whole tile leaves T = 1e-4:
    # under exit 1e-3 the disc behind it is not met, under 1e-5 it is.
    wall = [64.5, 8.5, 1e-8, 0.0, 1e-8, 1.0, 0.0, 0.0, 0.0, 1.0]
    (_, pairs), (_, pairs_low) = one_tile([wall, disc()])
    assert pairs == 2048
    assert pairs_low == 2048 + 69


def test_work_and_bounds():
    fwd = counts.composite_fwd(69, 1, 2048, "ewa")
    assert (fwd.flops, fwd.exps) == (22 * 69, 69)
    assert fwd.nbytes == (10 * 1 + 5 * 2048) * 4
    bwd = counts.composite_bwd(69, 1, 2048, "axis")
    assert bwd.flops == 60 * 69 and bwd.nbytes == (20 + 5 * 2048) * 4
    assert fwd.bound_s() == max(22 * 69 / 67e12, 69 / peaks.EXP_PER_S,
                                (10 + 5 * 2048) * 4 / 3.35e12)
    ewa = {"num_gaussians": 1, "floats_per_gaussian": 59,
           "footprint": "ewa", "sh_basis": "3dgs", "sh_degree": 3}
    step = counts.train_step(0, 0, 0, 1, ewa)
    assert step.flops == ((70 + 250 + 145) * 3 + 24 + 12 * 59)
    axis = {"num_gaussians": 1, "floats_per_gaussian": 19,
            "footprint": "axis", "sh_basis": "linear", "sh_degree": 1}
    step = counts.train_step(0, 0, 0, 1, axis)
    assert step.flops == ((70 + 12 + 32) * 3 + 24 + 12 * 19)
    frame = counts.serve_frame(0, 0, 1, axis)
    assert frame.flops == 70 + 12 + 32 + 8
    with pytest.raises(KeyError):
        counts.stage_fwd(1, {**axis, "sh_basis": "3dgs"})


def test_tile_lists_keep_the_nearest():
    # Three splats on one tile, camera z -1, -3, -2: near first is 0, 2, 1;
    # a capacity of 2 keeps 0 and 2.
    st = {"px": torch.tensor([10.0, 20.0, 30.0]),
          "py": torch.tensor([8.0, 8.0, 8.0]),
          "op": torch.tensor([0.5, 0.5, 0.5]),
          "sx": torch.ones(3), "sy": torch.ones(3),
          "zc": torch.tensor([-1.0, -3.0, -2.0])}
    slots, cnt = R.tile_lists(st, 128, 16, 8, 2)
    assert slots.tolist() == [[0, 2]] and cnt.tolist() == [2]
