"""The planners that pick the designs of kernel K1 and of its backward per
shape (`ops/groupnorm.py::_plan`, `_plan_backward`).

Pure arithmetic on shapes, so they are held here on the CPU. K1: at the 28
norm layers of the full coord net, 26 take the one-launch cluster design and
the two stem layers at 480x720 and 240x360 the one-launch grid design. K1-bwd,
whose slab is x and dy together: the 25 layers at 60x90 take clusters of 8
CTAs, stem3 a cluster of 16, stem2 the grid design, stem1 the grid design
in bf16 (its whole 64-byte pixels, holding what the card takes and
streaming the rest) and the four-kernel design in f32 (its x + dy outgrow
the card's shared memory, and 64-byte halves of its pixels measured slower
streaming); K1's stem1 in f32 holds what the card takes and streams the
rest. In f32 and bf16; every cluster plan obeys the limits of TMA and of
Hopper's clusters, every grid plan those of TMA and of a cooperative
launch; a slab one row beyond what the grid holds takes the three-pass or
four-kernel design. The kernels themselves run only on the
card (`tests/test_torch_cuda.py`).

The cross-shard kernels' planner (`_shard_plan`) at every shape those
kernels meet on the mesh's "spatial" axis: the coord net's layers, the MLR,
DUC and tiny-net widths, each image split into 2 and 4 row blocks.
"""
import numpy as np
import pytest
import torch

from crossloc_tpu_torch.ops.groupnorm import (
    _LINE_BYTES,
    _MIN_ROW_BYTES,
    _SLAB_PER_CTA,
    _SMEM_PER_CTA,
    _SHARD_GRID,
    _cluster_backward_smem,
    _cluster_smem,
    _grid_box,
    _grid_smem,
    _plan,
    _plan_backward,
    _shard_plan,
    _shard_smem,
)

# (C, H, W, layers per forward, design) of the 28 Conv->GN layers at 480x720
PATH = [
    (32, 480, 720, 1, "grid"),        # stem1: 22 MB slab (64 bytes a pixel)
    (64, 240, 360, 1, "grid"),        # stem2: 5.5 MB slab
    (128, 120, 180, 1, "cluster"),    # stem3
    (256, 60, 90, 4, "cluster"),      # stem4, res1_1..3
    (512, 60, 90, 21, "cluster"),     # res2..fc2 and res2_skip
]
DTYPES = [torch.float32, torch.bfloat16]


def _fit_limit(C, G, dtype, design="cluster", planner=_plan, B=1):
    """Largest H*W (as H x 1) that `planner` still sends to `design` (the
    designs take growing slabs in the order cluster, grid, and the old
    three-pass or four-kernel)."""
    lo, hi = 1, 1 << 22
    order = ["cluster", "grid"]
    assert order.index(planner(B, lo, 1, C, G, dtype).design) <= order.index(design)
    assert planner(B, hi, 1, C, G, dtype).design not in order
    while hi - lo > 1:
        mid = (lo + hi) // 2
        fits = planner(B, mid, 1, C, G, dtype).design in order[:order.index(design) + 1]
        lo, hi = (mid, hi) if fits else (lo, mid)
    return lo


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_main_path_designs(dtype):
    counts = {"cluster": 0, "grid": 0}
    for C, H, W, n, design in PATH:
        plan = _plan(8, H, W, C, min(32, C), dtype)
        assert plan.design == design, (C, H, W)
        counts[design] += n
    assert counts == {"cluster": 26, "grid": 2}


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", [(C, H, W) for C, H, W, _, _ in PATH] + [
    (1536, 60, 90), (2048, 60, 90), (96, 7, 13), (32, 5, 5), (64, 9, 11), (128, 1, 1),
    (1536, 17, 23), (512, 30, 45)], ids=lambda s: "x".join(map(str, s)))
def test_cluster_plans_obey_tma_and_cluster_limits(shape, dtype):
    C, H, W = shape
    G = min(32, C)
    plan = _plan(8, H, W, C, G, dtype)
    if plan.design == "grid":
        assert (C, H, W) in [(32, 480, 720), (64, 240, 360)]
        return
    item = torch.empty((), dtype=dtype).element_size()
    gs = C // G
    assert plan.cb % gs == 0 and C % plan.cb == 0
    row_bytes = plan.cb * item
    assert row_bytes >= _MIN_ROW_BYTES >= 32 and row_bytes % 16 == 0
    # the fewest whole groups that reach the minimum row
    assert not [k for k in range(gs, plan.cb, gs)
                if C % k == 0 and k * item >= _MIN_ROW_BYTES and k * item % 16 == 0]
    assert 1 <= plan.cluster <= 8 and plan.cb <= 256 and 1 <= plan.box_rows <= 256
    assert plan.smem_bytes <= _SMEM_PER_CTA == 227 * 1024
    assert plan.smem_bytes == _cluster_smem(item, plan.cb, gs, plan.box_rows, plan.nbox,
                                            plan.threads, plan.cluster)
    assert plan.rows_per_cta == plan.nbox * plan.box_rows
    # every CTA of the cluster holds rows, and together they cover H*W
    assert (plan.cluster - 1) * plan.rows_per_cta < H * W <= plan.cluster * plan.rows_per_cta
    if plan.nbox > 1:  # each box lands 128-byte aligned in shared memory
        assert plan.box_rows * row_bytes % 128 == 0
    vpr = row_bytes // 16
    assert plan.threads == vpr * (256 // vpr)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_two_ctas_share_an_sm_on_the_main_path(dtype):
    """The 25 layers at 60x90 fit two CTAs per SM; stem3's 1.4 MB slab takes
    8 CTAs of one SM each."""
    for C, H, W, _, design in PATH:
        plan = _plan(8, H, W, C, min(32, C), dtype)
        if design == "cluster" and H * W == 60 * 90:
            assert 2 * (plan.smem_bytes + 1024) <= 228 * 1024, (C, plan)
        elif design == "cluster":
            assert plan.cluster == 8 and plan.smem_bytes + 1024 > 228 * 1024 // 2, (C, plan)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("C", [256, 512, 2048])
def test_one_row_over_the_fit_limit_takes_three_pass(C, dtype):
    limit = _fit_limit(C, 32, dtype)
    at, over = _plan(1, limit, 1, C, 32, dtype), _plan(1, limit + 1, 1, C, 32, dtype)
    assert at.design == "cluster" and at.cluster == 8
    assert over.design == "grid"  # one row beyond the cluster: the grid design
    item = torch.empty((), dtype=dtype).element_size()
    # the cluster holds at most 8 x 200 KB of slab
    assert limit * at.cb * item <= 8 * 200 * 1024
    # one row beyond the grid: the three-pass design
    grid_limit = _fit_limit(C, 32, dtype, "grid")
    at, over = _plan(1, grid_limit, 1, C, 32, dtype), _plan(1, grid_limit + 1, 1, C, 32, dtype)
    assert at.design == "grid" and over.design == "three_pass"
    # the grid holds at most 132 x 200 KB and streams at most as much again
    assert grid_limit * at.cb * item <= 2 * 132 * _SLAB_PER_CTA


def test_shapes_tma_cannot_box_take_three_pass():
    # one group of 512 channels: a channel block wider than a 256-element box
    assert _plan(1, 4, 4, 512, 1, torch.float32).design == "three_pass"


# (C, H, W, K1-bwd calls per train step, design, CTAs per cluster) of K1-bwd
# on the coord net (the grid's CTAs per unit: test_grid_plans_hold_the_stems)
BWD_PATH = [
    (32, 480, 720, 1, None, None),        # stem1: 44 MB of x + dy an image (see below)
    (64, 240, 360, 1, "grid", None),      # stem2: 11 MB
    (128, 120, 180, 1, "cluster", 16),    # stem3: 2.8 MB, more than 8 x 200 KB
    (256, 60, 90, 4, "cluster", 8),
    (512, 60, 90, 21, "cluster", 8),
]
# the MLR merge norm at 60x90: (C, CTAs per cluster in f32, in bf16)
BWD_MLR = [(1536, 16, 8), (2048, 16, 8)]
# stem1's backward: the grid design streaming whole 64-byte pixels in bf16;
# in f32 the four-kernel design (test_stem1_backward_keeps_the_four_kernel_design)
STEM1_BACKWARD = {torch.float32: "four_kernel", torch.bfloat16: "grid"}


def _backward_fit_limit(C, G, dtype, design="cluster"):
    """Largest H*W (as H x 1) that the backward planner still sends to
    `design`."""
    return _fit_limit(C, G, dtype, design, _plan_backward)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_backward_main_path_designs(dtype):
    counts = {"cluster": 0, "grid": 0, "four_kernel": 0}
    for C, H, W, n, design, cluster in BWD_PATH:
        plan = _plan_backward(12, H, W, C, min(32, C), dtype)
        design = design or STEM1_BACKWARD[dtype]
        assert plan.design == design and cluster in (None, plan.cluster), (C, H, W)
        counts[design] += n
    f32 = dtype == torch.float32
    assert counts == {"cluster": 26, "grid": 1 if f32 else 2, "four_kernel": 1 if f32 else 0}
    for C, f32, bf16 in BWD_MLR:
        plan = _plan_backward(8, 60, 90, C, 32, dtype)
        assert (plan.design, plan.cluster) == ("cluster", f32 if dtype == torch.float32 else bf16)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", [(C, H, W) for C, H, W, _, _, _ in BWD_PATH] + [
    (1536, 60, 90), (2048, 60, 90), (96, 7, 13), (32, 5, 5), (64, 9, 11), (128, 1, 1),
    (1536, 17, 23), (512, 30, 45), (2048, 20, 30), (256, 61, 89)],
    ids=lambda s: "x".join(map(str, s)))
def test_backward_cluster_plans_obey_tma_and_cluster_limits(shape, dtype):
    C, H, W = shape
    G = min(32, C)
    plan = _plan_backward(8, H, W, C, G, dtype)
    item = torch.empty((), dtype=dtype).element_size()
    if plan.design in ("grid", "four_kernel"):
        assert (C, H, W) in [(32, 480, 720), (64, 240, 360)]
        return
    gs = C // G
    # the forward's channel block: whole groups, at least 64 bytes a pixel
    assert plan.cb == _plan(8, H, W, C, G, dtype).cb
    assert plan.cb % gs == 0 and C % plan.cb == 0
    row_bytes = plan.cb * item
    assert row_bytes >= _MIN_ROW_BYTES and row_bytes % 16 == 0
    assert plan.cluster in (1, 2, 4, 8, 16) and plan.cb <= 256 and 1 <= plan.box_rows <= 256
    if plan.cluster == 16:  # the non-portable size only where 8 CTAs cannot hold the slabs
        assert 2 * H * W * plan.cb * item > 8 * _SLAB_PER_CTA
    assert plan.smem_bytes <= _SMEM_PER_CTA == 227 * 1024
    assert plan.smem_bytes == _cluster_backward_smem(item, plan.cb, gs, plan.box_rows, plan.nbox,
                                                     plan.threads, plan.cluster)
    # x and dy together: at most _SLAB_PER_CTA a CTA
    assert 2 * plan.rows_per_cta * row_bytes <= _SLAB_PER_CTA
    assert plan.rows_per_cta == plan.nbox * plan.box_rows
    # every CTA of the cluster holds rows, and together they cover H*W
    assert (plan.cluster - 1) * plan.rows_per_cta < H * W <= plan.cluster * plan.rows_per_cta
    if plan.nbox > 1:  # each box lands 128-byte aligned in shared memory
        assert plan.box_rows * row_bytes % 128 == 0
    vpr = row_bytes // 16
    assert plan.threads == vpr * (256 // vpr)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("C", [256, 512])
def test_backward_two_ctas_share_an_sm_on_the_main_path(C, dtype):
    """The 25 layers at 60x90: x and dy of one (image, channel block) are
    691 KB, 8 CTAs of about 90 KB, two to an SM."""
    plan = _plan_backward(12, 60, 90, C, 32, dtype)
    assert plan.design == "cluster" and plan.cluster == 8
    assert 2 * (plan.smem_bytes + 1024) <= 228 * 1024, plan


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("C", [256, 512, 2048])
def test_backward_one_row_over_the_fit_limit_takes_four_kernel(C, dtype):
    limit = _backward_fit_limit(C, 32, dtype)
    at = _plan_backward(1, limit, 1, C, 32, dtype)
    over = _plan_backward(1, limit + 1, 1, C, 32, dtype)
    assert at.design == "cluster" and at.cluster == 16
    assert over.design == "grid"  # one row beyond the cluster: the grid design
    item = torch.empty((), dtype=dtype).element_size()
    # the cluster holds at most 16 x 200 KB of x and dy
    assert 2 * limit * at.cb * item <= 16 * _SLAB_PER_CTA
    # one row beyond the grid: the four-kernel design
    grid_limit = _backward_fit_limit(C, 32, dtype, "grid")
    at = _plan_backward(1, grid_limit, 1, C, 32, dtype)
    over = _plan_backward(1, grid_limit + 1, 1, C, 32, dtype)
    assert at.design == "grid" and over.design == "four_kernel"
    # at most 132 x 200 KB held, and at most as much again streamed
    assert 2 * grid_limit * at.cb * item <= 2 * 132 * _SLAB_PER_CTA


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", [(4, 4, 512, 1), (4, 4, 8, 1), (3, 5, 2048, 2)],
                         ids=lambda s: "x".join(map(str, s)))
def test_backward_shapes_tma_cannot_box_take_four_kernel(shape, dtype):
    """A channel block wider than a 256-element box (one group of 512 or of
    1024 channels), or a row too narrow for a 16-byte box (8 f32/bf16
    channels in one group: no block of whole groups reaches 64 bytes)."""
    H, W, C, G = shape
    assert _plan_backward(1, H, W, C, G, dtype).design == "four_kernel"


# the grid design: the stems at every batch the paths give them (one image,
# the scripts' 12 with its factor of 3, the spatial runs' 4, the eval and
# finetune batch 8, and tools/bench.py's 128)
GRID_STEMS = [(32, 480, 720), (64, 240, 360)]
GRID_BATCHES = [1, 3, 4, 8, 12, 128]
DIRECTIONS = {"forward": (_plan, 1), "backward": (_plan_backward, 2)}
# the (direction, stem, dtype) cases on the grid design; stem1's f32
# backward keeps the four-kernel design
GRID_CASES = [(d, stem, dt) for d in ("forward", "backward") for stem in GRID_STEMS
              for dt in DTYPES if (d, stem, dt) != ("backward", GRID_STEMS[0], torch.float32)]
# (direction, C, bytes an element) -> (bytes a pixel of the unit's block,
# streams): the planner's least cost, measured on the card (PERF.md): stem1's
# f32 forward holds 128-byte rows (the whole pixel) and streams the rest,
# its bf16 forward holds whole 64-byte pixels and its bf16 backward streams
# them, stem2 takes 64-byte blocks held whole (4 and 2 units an image)
GRID_BLOCKS = {("forward", 32, 4): (128, True), ("forward", 32, 2): (64, False),
               ("forward", 64, 4): (64, False), ("forward", 64, 2): (64, False),
               ("backward", 32, 2): (64, True),
               ("backward", 64, 4): (64, False), ("backward", 64, 2): (64, False)}


def _grid_case(direction, stem, dtype, batch):
    planner, slabs = DIRECTIONS[direction]
    C, H, W = stem
    return planner(batch, H, W, C, 32, dtype), slabs, C, H * W


def _case_id(case):
    return f"{case[0]}-{'x'.join(map(str, case[1]))}-{str(case[2])[6:]}"


@pytest.mark.parametrize("batch", GRID_BATCHES, ids=lambda b: f"B{b}")
@pytest.mark.parametrize("case", GRID_CASES, ids=_case_id)
def test_grid_plans_hold_the_stems(case, batch):
    direction, stem, dtype = case
    plan, slabs, C, HW = _grid_case(direction, stem, dtype, batch)
    assert plan.design == "grid"
    item = torch.empty((), dtype=dtype).element_size()
    gs = C // 32
    # whole groups; a TMA box of 16-byte multiples, at most 256 elements a side
    assert plan.cb % gs == 0 and C % plan.cb == 0
    row_bytes = plan.cb * item
    assert row_bytes % 16 == 0 and plan.cb <= 256 and 1 <= plan.box_rows <= 256
    held = plan.nbox * plan.box_rows
    streams = held < plan.rows_per_cta
    assert (row_bytes, streams) == GRID_BLOCKS[(direction, C, item)]
    # a block of whole lines or the whole pixel, else K1's 64-byte block
    assert plan.cb == C or row_bytes >= _LINE_BYTES or row_bytes == _MIN_ROW_BYTES
    # at most _SLAB_PER_CTA held a CTA, at most 132 CTAs a unit, and together
    # they cover H*W with rows in every CTA
    assert slabs * held * row_bytes <= _SLAB_PER_CTA
    assert 1 <= plan.cluster <= 132
    assert (plan.cluster - 1) * plan.rows_per_cta < HW <= plan.cluster * plan.rows_per_cta
    assert plan.nbox <= 32
    if streams:
        # whole lines or pixels; every SM's CTA a rank of the unit, streaming
        # at most what it holds, where the card cannot hold the slab
        assert plan.cb == C or row_bytes >= _LINE_BYTES
        assert plan.cluster == plan.grid == 132 and plan.rows_per_cta <= 2 * held
        assert slabs * HW * row_bytes > 132 * _SLAB_PER_CTA
    else:
        assert (plan.box_rows, plan.nbox, plan.rows_per_cta, plan.cluster) == _grid_box(
            HW, plan.cluster, row_bytes)
    if plan.nbox > 1:  # each box lands 128-byte aligned in shared memory
        assert plan.box_rows * row_bytes % 128 == 0
    vpr = row_bytes // 16
    assert plan.threads == vpr * (256 // vpr)
    assert plan.smem_bytes == _grid_smem(item, plan.cb, gs, plan.box_rows, plan.nbox,
                                         plan.threads, slabs == 2)
    assert plan.smem_bytes <= _SMEM_PER_CTA
    # one CTA an SM, every SM (or one CTA a pair), whole units a round
    units = batch * C // plan.cb
    assert plan.grid == min(132, units * plan.cluster) and plan.grid >= plan.cluster
    assert plan.grid == units * plan.cluster or plan.grid % plan.cluster == 0


@pytest.mark.parametrize("batch", GRID_BATCHES, ids=lambda b: f"B{b}")
def test_stem1_backward_keeps_the_four_kernel_design(batch):
    """In f32 stem1's x + dy (88 MB an image, 44 MB a 64-byte half pixel)
    outgrow the card's shared memory; whole 128-byte pixels would stream
    more than they hold, and the grid backward on 32-byte blocks held whole
    or on 64-byte halves streaming both measured slower than the four-kernel
    design (PERF.md), so the planner keeps it."""
    C, H, W = GRID_STEMS[0]
    assert 2 * H * W * 64 > 132 * _SLAB_PER_CTA
    assert _plan_backward(batch, H, W, C, 32, torch.float32).design == "four_kernel"
    assert _plan(batch, H, W, C, 32, torch.float32).design == "grid"


def _walk(units, k, grid):
    """Simulate the grid kernels' walk: CTA c takes pairs c, c + grid, ...
    in order, and a pair's barrier opens once every rank of its unit has
    arrived. Each step, every CTA with work arrives at its current pair (once)
    and leaves it if its unit is complete. Returns the pairs each CTA left,
    in order, and the steps taken; raises if no CTA can leave (deadlock)."""
    todo = [list(range(c, units * k, grid)) for c in range(grid)]
    left = [[] for _ in range(grid)]
    arrived, here = [0] * units, [None] * grid
    steps = 0
    while any(todo):
        steps += 1
        for c, t in enumerate(todo):
            if t and here[c] != t[0]:
                here[c] = t[0]
                arrived[t[0] // k] += 1
        moved = [c for c, t in enumerate(todo) if t and arrived[t[0] // k] == k]
        if not moved:
            raise AssertionError(f"deadlock: units {units}, k {k}, grid {grid}")
        for c in moved:
            left[c].append(todo[c].pop(0))
    return left, steps


@pytest.mark.parametrize("batch", GRID_BATCHES, ids=lambda b: f"B{b}")
@pytest.mark.parametrize("case", GRID_CASES, ids=_case_id)
def test_grid_walk_takes_every_pair_once_without_deadlock(case, batch):
    plan, _, C, _ = _grid_case(*case, batch)
    units = batch * C // plan.cb
    left, steps = _walk(units, plan.cluster, plan.grid)
    assert sorted(p for t in left for p in t) == list(range(units * plan.cluster))
    # the busiest CTA takes the rounds the planner counted; a unit whose
    # ranks straddle two rounds waits at most one step more
    rounds = -(-units * plan.cluster // plan.grid)
    assert max(len(t) for t in left) == rounds and rounds <= steps <= 2 * rounds


@pytest.mark.parametrize("k,grid,units", [(5, 7, 9), (7, 7, 3), (3, 4, 11), (131, 132, 16)])
def test_grid_walk_ends_when_units_straddle_ctas(k, grid, units):
    """Units whose ranks straddle two rounds (k not dividing the grid)."""
    left, _ = _walk(units, k, grid)
    assert sorted(p for t in left for p in t) == list(range(units * k))


# the cross-shard kernels: (C, H, W) of each norm the spatial axis splits (the
# coord net at 480x720, the MLR merge norms, the DUC widths, the tiny net at
# 96x144 with its MLR norms), and whether the grid must fill the card there
SHARD_WIDTHS = ([(C, H, W, (H, W) != (480, 720) and (H, W) != (240, 360))
                 for C, H, W, _, _ in PATH]
                + [(C, 60, 90, False) for C in (1536, 2048, 64, 128, 192, 384)]
                + [(32, 96, 144, False), (64, 48, 72, False), (128, 24, 36, False),
                   (128, 12, 18, False), (512, 12, 18, False)])
SPATIAL_BATCH = 4
# the spatial runs' batch, one image, and batches with a factor of 3 (the
# scripts' 12), whose thread counts are not powers of two
SHARD_BATCHES = [1, 3, SPATIAL_BATCH, 6, 12]


def _row_counts(HW, ctas, rows_per_cta, slots):
    """How often the CTAs' row slots visit each row: CTA i strides over
    [i * rows_per_cta, +rows_per_cta) from its slot, `slots` rows at a time."""
    seen = np.zeros(HW, dtype=int)
    for i in range(ctas):
        end = min(i * rows_per_cta + rows_per_cta, HW)
        for j in range(slots):
            seen[i * rows_per_cta + j:end:slots] += 1
    return seen


@pytest.mark.parametrize("batch", SHARD_BATCHES, ids=lambda b: f"B{b}")
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("tensors", [1, 2], ids=["stats", "backward"])
@pytest.mark.parametrize("splits", [2, 4])
@pytest.mark.parametrize("shape", SHARD_WIDTHS, ids=lambda s: "x".join(map(str, s[:3])))
def test_shard_plan_covers_each_block_within_the_card(shape, splits, tensors, dtype, batch):
    C, H, W, main = shape
    G = min(32, C)
    HW = H // splits * W
    plan = _shard_plan(batch, HW, C, G, dtype, tensors)
    item = torch.empty((), dtype=dtype).element_size()
    gs = C // G
    for cb, threads in ((plan.cb, plan.threads), (plan.apply_cb, plan.apply_threads)):
        # whole groups in whole 16-byte vectors, one thread a vector of a row
        assert cb % gs == 0 and C % cb == 0 and cb * item % 16 == 0
        vpr = cb * item // 16
        assert threads % vpr == 0 and vpr <= threads <= 512
    # a reduction whose rows divide a warp takes whole warps (its shuffles
    # span all 32 lanes)
    reduce_vpr = plan.cb * item // 16
    assert 32 % reduce_vpr or plan.threads % 32 == 0
    # the reductions: at least 64 bytes a pixel (K1's block); the applies:
    # whole rows where a CTA's 256 threads span them (all but the MLR norms
    # in f32), else half rows
    assert plan.cb * item >= _MIN_ROW_BYTES
    assert plan.apply_cb == (C if C * item <= 256 * 16 else C // 2)
    slots = plan.threads // (plan.cb * item // 16)
    # the reductions' cluster and the applies' row ranges visit each row once
    assert 1 <= plan.cluster <= 16
    assert (plan.cluster - 1) * plan.rows_per_cta < HW <= plan.cluster * plan.rows_per_cta
    assert (_row_counts(HW, plan.cluster, plan.rows_per_cta, slots) == 1).all()
    chunks = -(-HW // plan.apply_rows)
    apply_slots = plan.apply_threads // (plan.apply_cb * item // 16)
    assert plan.apply_rows >= apply_slots or chunks == 1
    assert (_row_counts(HW, chunks, plan.apply_rows, apply_slots) == 1).all()
    # the smallest cluster that reaches the planned grid (or holds a row a slot)
    pairs = batch * C // plan.cb
    target = _SHARD_GRID
    # (or the largest whose shared memory fits: a cluster's rank 0 holds every
    # rank's sums, which a batch of 12 at C=2048 in bf16 cannot double)
    assert (pairs * plan.cluster >= target or plan.cluster in (16, -(-HW // 1))
            or plan.rows_per_cta <= slots
            or _shard_smem(item, plan.cb, plan.threads, 2 * plan.cluster) > _SMEM_PER_CTA)
    assert plan.cluster == 1 or pairs * (plan.cluster // 2) < target
    assert plan.smem_bytes == _shard_smem(item, plan.cb, plan.threads, plan.cluster)
    assert plan.smem_bytes <= _SMEM_PER_CTA == 227 * 1024
    # the 26 layers at 120x180 and 60x90 fill the card's 132 SMs from the
    # spatial runs' batch on (one image of 128 channels holds 8 blocks of 64
    # bytes: 128 CTAs in clusters of 16)
    if main and batch >= SPATIAL_BATCH:
        assert pairs * plan.cluster >= 132
        assert batch * C // plan.apply_cb * chunks >= 132


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_shard_plan_refuses_what_no_cta_holds(dtype):
    # one group wider than 256 vectors of 16 bytes, or no rows
    assert _shard_plan(4, 100, 4096, 1, dtype) is None
    assert _shard_plan(4, 0, 512, 32, dtype) is None
    assert _shard_plan(4, 100, 2048, 2, dtype) is not None


def test_cross_shard_entries_take_the_twins_on_the_cpu():
    """A CPU tensor takes each entry's plain twin and counts no launch."""
    from crossloc_tpu_torch import ops

    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 6, 5, 64, generator=g) * 2 + 3
    s, b = torch.rand(64, generator=g) + 0.5, torch.randn(64, generator=g)
    dy = torch.randn(x.shape, generator=g)
    entries = (ops.group_norm_shard_stats, ops.group_norm_shard_apply,
               ops.group_norm_shard_backward_sums, ops.group_norm_shard_backward_apply)
    n0 = [f.launches for f in entries]
    stats = ops.group_norm_shard_stats(x, 32)
    assert torch.equal(stats, ops.group_norm_shard_stats_plain(x, 32))
    gathered = torch.stack([stats, stats])
    y, st = ops.group_norm_shard_apply(x, s, b, gathered, 32)
    yp, stp = ops.group_norm_shard_apply_plain(x, s, b, gathered, 32)
    assert torch.equal(y, yp) and torch.equal(st, stp)
    sums = ops.group_norm_shard_backward_sums(x, s, b, st, dy, 32)
    assert torch.equal(sums, ops.group_norm_shard_backward_sums_plain(x, s, b, st, dy, 32))
    got = ops.group_norm_shard_backward_apply(x, s, b, st, dy, torch.stack([sums, sums]), 1, 32,
                                              60)
    ref = ops.group_norm_shard_backward_apply_plain(x, s, b, st, dy, torch.stack([sums, sums]),
                                                    1, 32, 60)
    assert all(torch.equal(a, r) for a, r in zip(got, ref))
    assert [f.launches for f in entries] == n0


def test_grid_walk_deadlocks_where_a_unit_outnumbers_the_grid():
    """Why the kernels refuse k > grid (grid_plan_ok): a unit's ranks would
    share CTAs, and its first ranks wait on ranks queued behind them."""
    with pytest.raises(AssertionError, match="deadlock"):
        _walk(2, 5, 3)
