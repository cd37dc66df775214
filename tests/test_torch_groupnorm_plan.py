"""The planner that picks kernel K1's design per shape (`ops/groupnorm.py::_plan`).

Pure arithmetic on shapes, so it is held here on the CPU: at the 28 norm
layers of the full coord net, 26 take the one-launch cluster design and the
two stem layers at 480x720 and 240x360 the three-pass design, in f32 and
bf16; every cluster plan obeys the limits of TMA and of Hopper's clusters.
The kernels themselves run only on the card (`tests/test_torch_cuda.py`).
"""
import pytest
import torch

from crossloc_tpu_torch.ops.groupnorm import _MIN_ROW_BYTES, _SMEM_PER_CTA, _cluster_smem, _plan

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
