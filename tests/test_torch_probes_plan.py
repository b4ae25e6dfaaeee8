"""The launch plans of the probes' online, single-pass and copy kernels
(``seed_story_torch.benchmarks.probe_kernels``), on the CPU.

The online kernel runs blocks of ``block_q`` query rows of one head; its
plan must cover every query tile of every head once and keep each
block's shared memory within a block's limit, and two 64-row blocks
within an SM's.

The single pass runs each head (or head pair) on clusters of blocks of
128 query rows; its plan must keep a cluster within Hopper's portable
limit of 8, give
the card at least one block an SM at the probe shapes and cover every
query row of every head exactly once. The copy runs blocks of (head,
span); its plan must tile every head's 16-byte units exactly once, with
at least 4 blocks an SM at the probe shapes. The kernels themselves run
only on the card (``tests/test_torch_probes_gpu.py``).
"""

import pytest

from seed_story_torch.benchmarks import probe_kernels as pk

SMS = 132  # an H100 SXM's multiprocessors
SP_SHAPES = [(2, 20, 1024, 64), (2, 10, 2048, 64)]  # the JAX probes' single-pass shapes
COPY_SHAPES = [(2, 20, 1024, 64), (2, 10, 2048, 64), (2, 10, 4096, 64), (2, 10, 1024, 128)]
# heads a program: the packed pairs' plan is the two-head one over B x H/2 pairs
LAYOUTS = {"single_pass": 1, "single_pass_fused_bh": 2, "attn_packed2": 2}


def _rows_covered(plan, s):
    """(group, query row) -> how many blocks store it, as the kernel walks
    the grid: block i of a group owns rows SP_ROWS * i onward, below s."""
    per_group = plan.blocks // plan.groups
    seen = {}
    for block in range(plan.blocks):
        group, i = divmod(block, per_group)
        for row in range(pk.SP_ROWS * i, min(pk.SP_ROWS * (i + 1), s)):
            seen[group, row] = seen.get((group, row), 0) + 1
    return seen


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("shape", SP_SHAPES)
def test_single_pass_plan_fills_the_card_at_the_probe_shapes(shape, layout):
    b, h, s, _ = shape
    heads = LAYOUTS[layout]
    plan = pk.single_pass_plan(b, h, s, heads)
    assert 1 <= plan.cluster <= pk.SP_MAX_CLUSTER == 8
    assert plan.blocks >= SMS
    assert plan.groups == b * h // heads
    assert plan.clusters == plan.groups * plan.clusters_per_group
    assert plan.blocks == plan.clusters * plan.cluster


@pytest.mark.parametrize("max_cluster", [3, 8])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("s", [64, 128, 192, 256, 640, 1024, 1152, 2048, 4096])
def test_single_pass_plan_covers_every_query_row_once(s, layout, max_cluster):
    heads = LAYOUTS[layout]
    plan = pk.single_pass_plan(1, 4, s, heads, max_cluster)
    assert 1 <= plan.cluster <= max_cluster
    seen = _rows_covered(plan, s)
    assert set(seen) == {(g, r) for g in range(plan.groups) for r in range(s)}
    assert set(seen.values()) == {1}
    # no cluster lies wholly past the sequence: its blocks would only load
    per_group = plan.blocks // plan.groups
    assert (per_group - plan.cluster) * pk.SP_ROWS < s
    if s == 64:
        assert plan == pk.SinglePassPlan(plan.groups, 1, 1, plan.groups, plan.groups)


def test_single_pass_plan_at_2048_keys_takes_two_clusters_of_8():
    """S = 2048 needs 16 row blocks: two portable clusters of 8 a head; no
    plan asks for a cluster above the portable 8."""
    assert pk.single_pass_plan(2, 10, 2048, 1)[1:3] == (8, 2)
    for max_cluster in (0, 16):
        with pytest.raises(ValueError, match="clusters take 1 to 8"):
            pk.single_pass_plan(2, 10, 2048, 1, max_cluster)


def _units_covered(plan, heads):
    seen = {}
    for block in range(plan.blocks):
        head, span = divmod(block, plan.spans_per_head)
        start = span * plan.span_units
        for unit in range(start, min(start + plan.span_units, plan.head_units)):
            seen[head, unit] = seen.get((head, unit), 0) + 1
    return seen


@pytest.mark.parametrize("shape", COPY_SHAPES + [(1, 3, 40, 8), (1, 1, 8, 8), (3, 5, 77, 24)])
def test_copy_plan_tiles_every_head_once(shape):
    b, h, s, d = shape
    plan = pk.copy_plan(b, h, s, d, SMS)
    assert plan.head_units * 8 == s * d
    assert 1 <= plan.span_units <= pk.COPY_MAX_SPAN
    assert plan.blocks == b * h * plan.spans_per_head
    seen = _units_covered(plan, b * h)
    assert set(seen) == {(hd, u) for hd in range(b * h) for u in range(plan.head_units)}
    assert set(seen.values()) == {1}
    if shape in COPY_SHAPES:
        assert plan.blocks >= 4 * SMS
    if shape == (1, 3, 40, 8):  # a head of 640 bytes: one span of 40 units
        assert (plan.span_units, plan.spans_per_head, plan.blocks) == (40, 1, 3)


ATTN_SHAPES = [(2, 10, 4096, 64), (2, 20, 1024, 64)]  # the JAX variants probe's shapes


@pytest.mark.parametrize("tile", pk.TILES)
@pytest.mark.parametrize("shape", ATTN_SHAPES + [(1, 1, 128, 64), (3, 5, 256, 64),
                                                 (5, 27, 256, 64), (1, 1, 4096, 64)])
def test_attn_plan_covers_every_query_tile_once(shape, tile):
    """Block (x, y, z) of the grid owns query rows block_q x .. block_q (x
    + 1) - 1 of head y of batch row z, as the kernel reads blockIdx."""
    b, h, s, _ = shape
    block_q, block_kv = tile
    plan = pk.attn_plan(b, h, s, block_q, block_kv, SMS)
    assert plan.grid == (s // block_q, h, b) and plan.blocks == s // block_q * h * b
    seen = {}
    for z in range(plan.grid[2]):
        for y in range(plan.grid[1]):
            for x in range(plan.grid[0]):
                for row in range(block_q * x, block_q * (x + 1)):
                    seen[z, y, row] = seen.get((z, y, row), 0) + 1
    assert set(seen) == {(z, y, r) for z in range(b) for y in range(h) for r in range(s)}
    assert set(seen.values()) == {1}


@pytest.mark.parametrize("tile", pk.TILES)
def test_attn_plan_fits_a_block_and_an_sm(tile):
    """A block's shared memory (Q, the ring, the barriers and 1 KB to align
    the base) within 232,448 bytes; the blocks planned an SM, each with
    the 1 KB the card keeps, within its 233,472; a ring of at least three
    stages (tile t + 1's K and tile t's V in use while one refills)."""
    block_q, block_kv = tile
    plan = pk.attn_plan(2, 10, 4096, block_q, block_kv, SMS)
    assert plan.warpgroups == block_q // 64
    assert plan.threads == 128 * plan.warpgroups + 32
    assert plan.blocks_per_sm == (2 if block_q == 64 else 1)
    ring = plan.stages * 2 * block_kv * 128
    assert plan.stages >= 3
    assert plan.smem_bytes == block_q * 128 + ring + 8 * (1 + 2 * plan.stages) + 1024
    assert plan.smem_bytes <= pk.SMEM_PER_BLOCK == 232448
    assert plan.blocks_per_sm * (plan.smem_bytes + 1024) <= pk.SMEM_PER_SM == 233472


@pytest.mark.parametrize("tile,want", [
    ((128, 128), [(32, 10, 2), 640, 5, (8, 20, 2), 320, 3]),
    ((128, 64), [(32, 10, 2), 640, 5, (8, 20, 2), 320, 3]),
    ((64, 128), [(64, 10, 2), 1280, 5, (16, 20, 2), 640, 3]),
    ((64, 64), [(64, 10, 2), 1280, 5, (16, 20, 2), 640, 3]),
])
def test_attn_plan_grid_at_the_probe_shapes(tile, want):
    """One block a query tile: 640 (or 1280 of 64 rows, two an SM) at
    (2, 10, 4096, 64) take 5 rounds of 132 SMs, 320 (640) at (2, 20, 1024,
    64) take 3 rounds for 2.4 of work."""
    got = []
    for b, h, s, _ in ATTN_SHAPES:
        plan = pk.attn_plan(b, h, s, *tile, SMS)
        got += [plan.grid, plan.blocks, plan.rounds]
    assert got == want


def test_attn_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="no instance"):
        pk.attn_plan(1, 1, 1024, 256, 128, SMS)
    with pytest.raises(ValueError, match="not a multiple"):
        pk.attn_plan(1, 1, 192, 128, 128, SMS)
