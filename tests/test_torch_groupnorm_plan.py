"""The planners that pick the designs of kernel K1 and of its backward per
shape (`ops/groupnorm.py::_plan`, `_plan_backward`).

Pure arithmetic on shapes, so they are held here on the CPU. K1: at the 28
norm layers of the full coord net, 26 take the one-launch cluster design and
the two stem layers at 480x720 and 240x360 the three-pass design. K1-bwd,
whose slab is x and dy together: the 25 layers at 60x90 take clusters of 8
CTAs, stem3 a cluster of 16, stem1 and stem2 the four-kernel design. In f32
and bf16; every
cluster plan obeys the limits of TMA and of Hopper's clusters. The kernels
themselves run only on the card (`tests/test_torch_cuda.py`).

The cross-shard kernels' planner (`_shard_plan`) at every shape those
kernels meet on the mesh's "spatial" axis: the coord net's layers, the MLR,
DUC and tiny-net widths, each image split into 2 and 4 row blocks.
"""
import numpy as np
import pytest
import torch

from crossloc_tpu_torch.ops.groupnorm import (
    _MIN_ROW_BYTES,
    _SLAB_PER_CTA,
    _SMEM_PER_CTA,
    _SHARD_GRID,
    _cluster_backward_smem,
    _cluster_smem,
    _plan,
    _plan_backward,
    _shard_plan,
    _shard_smem,
)

# (C, H, W, layers per forward, design) of the 28 Conv->GN layers at 480x720
PATH = [
    (32, 480, 720, 1, "three_pass"),  # stem1: 11 MB slab
    (64, 240, 360, 1, "three_pass"),  # stem2: 2.8 MB slab
    (128, 120, 180, 1, "cluster"),    # stem3
    (256, 60, 90, 4, "cluster"),      # stem4, res1_1..3
    (512, 60, 90, 21, "cluster"),     # res2..fc2 and res2_skip
]
DTYPES = [torch.float32, torch.bfloat16]


def _fit_limit(C, G, dtype):
    """Largest H*W (as H x 1) that the planner still sends to the cluster."""
    lo, hi = 1, 1 << 22
    assert _plan(1, lo, 1, C, G, dtype).design == "cluster"
    assert _plan(1, hi, 1, C, G, dtype).design == "three_pass"
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if _plan(1, mid, 1, C, G, dtype).design == "cluster" else (lo, mid)
    return lo


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_main_path_designs(dtype):
    counts = {"cluster": 0, "three_pass": 0}
    for C, H, W, n, design in PATH:
        plan = _plan(8, H, W, C, min(32, C), dtype)
        assert plan.design == design, (C, H, W)
        counts[design] += n
    assert counts == {"cluster": 26, "three_pass": 2}


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", [(C, H, W) for C, H, W, _, _ in PATH] + [
    (1536, 60, 90), (2048, 60, 90), (96, 7, 13), (32, 5, 5), (64, 9, 11), (128, 1, 1),
    (1536, 17, 23), (512, 30, 45)], ids=lambda s: "x".join(map(str, s)))
def test_cluster_plans_obey_tma_and_cluster_limits(shape, dtype):
    C, H, W = shape
    G = min(32, C)
    plan = _plan(8, H, W, C, G, dtype)
    if plan.design == "three_pass":
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
    assert over.design == "three_pass"
    item = torch.empty((), dtype=dtype).element_size()
    # the cluster holds at most 8 x 200 KB of slab
    assert limit * at.cb * item <= 8 * 200 * 1024


def test_shapes_tma_cannot_box_take_three_pass():
    # one group of 512 channels: a channel block wider than a 256-element box
    assert _plan(1, 4, 4, 512, 1, torch.float32).design == "three_pass"


# (C, H, W, K1-bwd calls per train step, design, CTAs per cluster) of K1-bwd
# on the coord net
BWD_PATH = [
    (32, 480, 720, 1, "four_kernel", 0),  # stem1: 44 MB of x + dy per channel block
    (64, 240, 360, 1, "four_kernel", 0),  # stem2: 11 MB
    (128, 120, 180, 1, "cluster", 16),    # stem3: 2.8 MB, more than 8 x 200 KB
    (256, 60, 90, 4, "cluster", 8),
    (512, 60, 90, 21, "cluster", 8),
]
# the MLR merge norm at 60x90: (C, CTAs per cluster in f32, in bf16)
BWD_MLR = [(1536, 16, 8), (2048, 16, 8)]


def _backward_fit_limit(C, G, dtype):
    """Largest H*W (as H x 1) that the backward planner still sends to the
    cluster."""
    lo, hi = 1, 1 << 22
    assert _plan_backward(1, lo, 1, C, G, dtype).design == "cluster"
    assert _plan_backward(1, hi, 1, C, G, dtype).design == "four_kernel"
    while hi - lo > 1:
        mid = (lo + hi) // 2
        fits = _plan_backward(1, mid, 1, C, G, dtype).design == "cluster"
        lo, hi = (mid, hi) if fits else (lo, mid)
    return lo


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_backward_main_path_designs(dtype):
    counts = {"cluster": 0, "four_kernel": 0}
    for C, H, W, n, design, cluster in BWD_PATH:
        plan = _plan_backward(12, H, W, C, min(32, C), dtype)
        assert (plan.design, plan.cluster) == (design, cluster), (C, H, W)
        counts[design] += n
    assert counts == {"cluster": 26, "four_kernel": 2}
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
    if plan.design == "four_kernel":
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
    assert over.design == "four_kernel"
    item = torch.empty((), dtype=dtype).element_size()
    # the cluster holds at most 16 x 200 KB of x and dy
    assert 2 * limit * at.cb * item <= 16 * _SLAB_PER_CTA


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", [(4, 4, 512, 1), (4, 4, 8, 1), (3, 5, 2048, 2)],
                         ids=lambda s: "x".join(map(str, s)))
def test_backward_shapes_tma_cannot_box_take_four_kernel(shape, dtype):
    """A channel block wider than a 256-element box (one group of 512 or of
    1024 channels), or a row too narrow for a 16-byte box (8 f32/bf16
    channels in one group: no block of whole groups reaches 64 bytes)."""
    H, W, C, G = shape
    assert _plan_backward(1, H, W, C, G, dtype).design == "four_kernel"


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
