"""A drawn request changes only values that travel as kernel parameters:
its kernel sources equal those of the script's own values, so no request
of a window builds a library."""

import pytest
import torch

import sdf_torch
from conftest import small_cell
from sdf_torch.core import eval_classify
from traffic import Traffic


@pytest.mark.parametrize("name", ["knurling.edit_2p26", "blobby.edit_2p26",
                                  "knurling.edit_2p22"])
def test_drawn_requests_share_the_kernel_source(name):
    cell = small_cell(name)
    base = cell.build(sdf_torch, cell.config["params"])
    traffic = Traffic(cell.traffic, cell.config, 2**31 + 99)
    draws = [traffic.request(i) for i in range(3)] + traffic.warmup()
    for params in draws:
        f = cell.build(sdf_torch, params)
        for source in (eval_classify.kernel_source,
                       eval_classify.tile_kernel_source):
            assert source(f, None, torch.float32) == source(
                base, None, torch.float32)
