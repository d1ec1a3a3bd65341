"""K13's wrapper on the CPU: its plain version writes one position per
row at the edges of a row's 32-byte sectors. The kernel runs only on the
card (tests/test_torch_kernels_cuda.py:test_cache_col_write_at_sector_edges).
"""

import pytest
import torch

from spittle_tpu_torch.ops import cache_write as cw


@pytest.mark.parametrize("ctx", [128, 136, 100])
@pytest.mark.parametrize("pos", [0, 7, 8, 15, 16, -1])
def test_col_write_plain_at_sector_edges(ctx, pos):
    """The wrapper on the CPU (its plain version) writes exactly one
    position per row at the edges of the 16-position sectors of a row of
    bf16, the rest of the cache unchanged."""
    gen = torch.Generator().manual_seed(ctx)
    cache = torch.randn((3, 5, ctx), generator=gen).to(torch.bfloat16)
    cols = torch.randn((3, 5), generator=gen).to(torch.bfloat16)
    pos = pos % ctx
    keep = cache.clone()
    got = cw.alias_col_write(cache, cols, torch.tensor(pos, dtype=torch.int32))
    assert got is cache
    assert torch.equal(cache[..., pos], cols)
    others = torch.ones(ctx, dtype=torch.bool)
    others[pos] = False
    assert torch.equal(cache[..., others], keep[..., others])
