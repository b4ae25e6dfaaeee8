"""The launch plans of the probes' single-pass and copy kernels
(``seed_story_torch.benchmarks.probe_kernels``), on the CPU.

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
