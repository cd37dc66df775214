"""Fused GroupNorm(+ReLU) over NHWC activations: kernel K1 and its plain twin.

`group_norm_relu` is the norm inside every `ConvGN` of the port. On a CUDA
tensor it launches the hand-written kernel of `csrc/groupnorm.cu` or raises;
on a CPU tensor it runs `group_norm_relu_plain`. Nothing falls back from the
kernel to the plain version. `_plan` picks the kernel's design per shape:
one cluster launch that reads x once where a slab of one image fits a thread
block cluster's shared memory; else one cooperative grid launch that reads x
once where the slab fits the card's shared memory (the stems); the
three-pass design (stats, finalize, apply) beyond that; the note at the top
of the source says why. `_plan_backward` does the same for the backward,
whose slab is x and dy together: the cluster design (clusters of up to 16
CTAs), the grid design, or the four-kernel design that reads both twice.
Where a slab outgrows the card's shared memory, the grid design holds what
it takes and streams the rest from device memory, read twice.

Semantics match `crossloc_tpu/ops/pallas_groupnorm.py` (`_kernel`, and its
reference `_gn_reference`): contiguous channel groups, fp32 statistics with
the centred variance, affine, optional ReLU, output in the input's dtype.

The gradient: on CUDA tensors the forward also writes (mu, rstd) per (image,
group), and the backward launches the hand-written backward kernel
(`group_norm_relu_backward`) or raises; on CPU tensors it is the autograd of
the plain version (`group_norm_relu_backward_plain`), as the JAX `_bwd`
(`pallas_groupnorm.py:141`) is the vjp of its reference. At an exact tie
pre-activation == 0 the ReLU passes no gradient (torch's rule; JAX's
`jnp.maximum` passes half), so tests keep their inputs off the kink.

The cross-shard form, for the mesh's "spatial" axis: an image's rows are
split over the ranks of a spatial group, so the statistics span ranks. Four
entries, each one kernel launch on CUDA tensors (its geometry from
`_shard_plan`) and a plain twin on CPU tensors;
`parallel/spatial.py::group_norm_relu_spatial` all-gathers over the group
between the two of each direction: `group_norm_shard_stats` (per (image,
group) count, mean and M2 of the shard), `group_norm_shard_apply` (the
ranks' statistics merged in rank order, then the norm),
`group_norm_shard_backward_sums` (per (image, channel) sums of the shard)
and `group_norm_shard_backward_apply` (the ranks' sums added in rank order,
dx with the image's whole H*W as the count, and this shard's part of dscale
and dbias, which the training step's all-reduce adds over the ranks).
"""
from __future__ import annotations

import ctypes
import functools
import itertools
import math
from typing import NamedTuple

import torch

GN_EPS = 1e-5  # torch nn.GroupNorm default, the nets' normaliser
_TARGET_STATS_BLOCKS = 1056  # 8 blocks per SM on a 132-SM H100
_VEC_BYTES = 16  # one vector load; also TMA's unit for strides and inner boxes
_WARP = 32
# the narrowest row of a channel block: two 32-byte sectors, the unit HBM
# moves. Measured on an H100 against 32 B (one sector): as fast or faster at
# every shape of the main path (PERF.md)
_MIN_ROW_BYTES = 64
# the grid design's channel blocks: whole L2 lines (or the whole pixel), at
# most 16 vectors a row
_LINE_BYTES = 128
_GRID_MAX_ROW_BYTES = 256
_CLUSTER_SIZES = (1, 2, 4, 8)  # up to the portable 8 (no opt-in); powers of two pack GPCs
# K1-bwd, after the portable sizes: 16 CTAs, which H100 allows on request
# (non-portable); its GPCs hold 16-18 SMs
_CLUSTER_SIZES_NON_PORTABLE = (16,)
_CLUSTER_THREADS = 256
_BOX_MAX = 256  # TMA box: at most 256 elements along each dimension
_SMEM_PER_CTA = 232448  # 227 KB, the most one block may ask for on Hopper
_SLAB_PER_CTA = 200 * 1024  # slab bytes one CTA may hold (leaves room for the rest)
# shared memory bytes per CTA, tried in order: two CTAs share an SM's 228 KB
# (1 KB of it reserved per CTA), so one CTA's loads overlap another's
# statistics; else one CTA per SM
_CTA_SMEM_LIMITS = (228 * 1024 // 2 - 1024, _SMEM_PER_CTA)
_SMS = 132  # an H100 SXM's SMs: the grid design's planning default
_GRID_MAX_BOXES = 32  # the grid kernels keep their boxes' mbarrier parities in one word
# the grid planner's cost, in bytes an SM streams (its share of 3.35 TB/s
# is about 25 GB/s): a round's fixed cost (the statistics tail, the unit's
# barrier and merge, while its own loads and stores idle), and the weight of
# the unit's partials each CTA adds (latency-bound L2 reads); set so that the
# planner picks, at every stem row, the plan measured fastest (PERF.md)
_GRID_ROUND_BYTES = 192 * 1024
_GRID_MERGE_WEIGHT = 2
# the cross-shard kernels (`_shard_plan`): the reductions' cluster sizes,
# the least grid they aim for in CTAs (an H100 has 132 SMs), and the threads
# they aim for across the grid, times the tensors each thread reads (1 for
# the statistics, 2 for the backward's sums: about 1,000 a SM); the
# applies' threads and grid
_SHARD_CLUSTER_SIZES = (1, 2, 4, 8, 16)
_SHARD_GRID = 132
_SHARD_LOADS = 1 << 17
_SHARD_THREADS = (256, 512)  # the least and the most threads of a reduction CTA
_SHARD_APPLY_THREADS = 256
_SHARD_APPLY_GRID = 2 * 132
_SHARD_MAX_VECTORS = 256  # vectors of 16 bytes in a CTA's row slice
_LIB = None


def group_norm_relu_plain(x, scale, bias, groups: int, eps: float = GN_EPS, relu: bool = True):
    """Plain PyTorch GroupNorm(+ReLU) on NHWC `x`: fp32 two-pass statistics."""
    B, H, W, C = x.shape
    xf = x.float().reshape(B, H * W, groups, C // groups)
    mu = xf.mean(dim=(1, 3), keepdim=True)
    var = (xf - mu).square().mean(dim=(1, 3), keepdim=True)
    y = ((xf - mu) * torch.rsqrt(var + eps)).reshape(B, H, W, C)
    y = y * scale.float() + bias.float()
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype)


def _check(x, scale, bias, groups: int) -> None:
    if x.dim() != 4:
        raise ValueError(f"expected NHWC input, got shape {tuple(x.shape)}")
    C = x.shape[-1]
    if scale.shape != (C,) or bias.shape != (C,):
        raise ValueError(
            f"scale/bias of {tuple(scale.shape)}/{tuple(bias.shape)} do not match channels {C}")
    if groups < 1 or C % groups != 0:
        raise ValueError(f"channels {C} are not divisible into {groups} groups")


class Plan(NamedTuple):
    """How K1 or K1-bwd runs one shape (see `_plan`, `_plan_backward`)."""
    design: str         # "cluster", "grid", or "three_pass" (K1) / "four_kernel" (K1-bwd)
    cb: int             # channels per cluster or unit (whole groups); 0 otherwise
    cluster: int        # CTAs per cluster; "grid": CTAs per unit (image, channel block)
    rows_per_cta: int   # H*W rows each CTA holds (the last CTA may hold fewer)
    box_rows: int       # rows per TMA box
    nbox: int           # boxes per CTA
    threads: int        # threads per CTA
    smem_bytes: int     # dynamic shared memory per CTA
    grid: int = 0       # "grid": CTAs launched, all resident at once


_THREE_PASS = Plan("three_pass", 0, 0, 0, 0, 0, 0, 0)
_FOUR_KERNEL = Plan("four_kernel", 0, 0, 0, 0, 0, 0, 0)


def _channel_block(C: int, G: int, itemsize: int) -> int:
    """Fewest whole groups whose bytes per pixel reach _MIN_ROW_BYTES and are
    a multiple of 16 (TMA's inner-box rule); 0 if none divides C."""
    gs = C // G
    for k in range(1, G + 1):
        cb = k * gs
        if G % k == 0 and cb * itemsize >= _MIN_ROW_BYTES and cb * itemsize % _VEC_BYTES == 0:
            return cb
    return 0


def _red_slots(cb: int, itemsize: int, threads: int) -> int:
    """Row slots of the reduction scratch left after a warp's shuffles."""
    vpr = cb * itemsize // _VEC_BYTES
    return threads // _WARP if _WARP % vpr == 0 else threads // vpr


def _cluster_smem(itemsize: int, cb: int, gs: int, box_rows: int, nbox: int, threads: int,
                  cluster: int) -> int:
    """Dynamic shared memory of one forward CTA: alignment pad, slab, one
    mbarrier per box, the reduction scratch (two sums per channel and row
    slot), and the statistics, every rank's among them (the kernel's layout)."""
    slots = _red_slots(cb, itemsize, threads)
    return (128 + nbox * box_rows * cb * itemsize + 8 * nbox
            + 4 * (2 * slots * cb + (2 * cluster + 4) * (cb // gs)))


def _cluster_backward_smem(itemsize: int, cb: int, gs: int, box_rows: int, nbox: int,
                           threads: int, cluster: int) -> int:
    """Dynamic shared memory of one backward CTA: alignment pad, the slabs of
    x (padded to 128 bytes) and dy, one mbarrier per box pair, the reduction
    scratch, this CTA's, every rank's and the image's two sums per channel,
    and two coefficients per group (the kernel's layout)."""
    slots = _red_slots(cb, itemsize, threads)
    slab = nbox * box_rows * cb * itemsize
    return (128 + -(-slab // 128) * 128 + -(-slab // 16) * 16 + 8 * nbox
            + 4 * (2 * slots * cb + (2 * cluster + 4) * cb + 2 * (cb // gs)))


def _cluster_plan(HW: int, C: int, G: int, itemsize: int, slabs: int, smem_fn,
                  size_groups=(_CLUSTER_SIZES,)):
    """The cluster plan for `slabs` tensors of [H*W, cb] held per (image,
    channel block), or None where none fits: within each group of cluster
    sizes in turn, the smallest cluster whose CTAs are small enough that two
    share an SM, else the smallest whose CTAs hold at most _SLAB_PER_CTA
    bytes of slab (one CTA per SM)."""
    gs = C // G
    cb = _channel_block(C, G, itemsize)
    vpr = cb * itemsize // _VEC_BYTES
    if cb == 0 or cb > _BOX_MAX or vpr > _CLUSTER_THREADS or C * itemsize % _VEC_BYTES:
        return None
    threads = vpr * (_CLUSTER_THREADS // vpr)
    for sizes, smem_limit in itertools.product(size_groups, _CTA_SMEM_LIMITS):
        for cs in sizes:
            rows = -(-HW // cs)
            nbox = -(-rows // _BOX_MAX)
            box_rows = -(-rows // nbox)
            if nbox > 1:  # each box starts 128-byte aligned in shared memory
                box_rows = -(-box_rows // 8) * 8
            rows_per_cta = nbox * box_rows
            cluster = -(-HW // rows_per_cta)  # every CTA holds rows
            smem = smem_fn(itemsize, cb, gs, box_rows, nbox, threads, cluster)
            if slabs * rows_per_cta * cb * itemsize <= _SLAB_PER_CTA and smem <= smem_limit:
                return Plan("cluster", cb, cluster, rows_per_cta, box_rows, nbox, threads, smem)
    return None


def _grid_smem(itemsize: int, cb: int, gs: int, box_rows: int, nbox: int, threads: int,
               backward: bool) -> int:
    """Dynamic shared memory of one grid CTA (the kernels' layouts): as the
    cluster designs' without the exchange slots (the mbarriers rounded to an
    even count), plus the merge's stage (4 floats a thread), the unit's two
    sums per channel, and the pivots, means and rstd (forward) or the two
    coefficients per group (backward)."""
    slots = _red_slots(cb, itemsize, threads)
    slab = nbox * box_rows * cb * itemsize
    slabs = -(-slab // 128) * 128 + -(-slab // 16) * 16 if backward else -(-slab // 16) * 16
    tail = (2 if backward else 3) * cb + 2 * (cb // gs)
    return 128 + slabs + 16 * -(-nbox // 2) + 4 * (2 * slots * cb + 4 * threads + tail)


def _grid_box(HW: int, k: int, row_bytes: int):
    """(box_rows, nbox, rows_per_cta, ranks) when H*W rows are cut for k
    CTAs, in at most _GRID_MAX_BOXES boxes of at most _BOX_MAX rows, each
    box 128-byte aligned in shared memory: the fewest boxes whose rows leave
    all k CTAs rows, else the fewest rows a CTA; None where no cut fits."""
    rows = -(-HW // k)
    align = 128 // math.gcd(128, row_bytes)
    cuts = []
    for nbox in range(-(-rows // _BOX_MAX), _GRID_MAX_BOXES + 1):
        box_rows = -(-rows // nbox)
        box_rows = -(-box_rows // align) * align if nbox > 1 else box_rows
        if box_rows <= _BOX_MAX:
            cuts.append((box_rows, nbox, nbox * box_rows, -(-HW // (nbox * box_rows))))
    whole = [c for c in cuts if c[3] == k]
    return whole[0] if whole else min(cuts, key=lambda c: c[2], default=None)


def _grid_blocks(C: int, G: int, itemsize: int):
    """The grid design's channel blocks in the order it tries them: whole
    groups in 16-byte vectors, at most _GRID_MAX_ROW_BYTES a pixel, that are
    the whole pixel or whole L2 lines, widest first (a strided block narrower
    than a line costs HBM part of a line each row: measured, PERF.md); then
    K1's block of _MIN_ROW_BYTES, if it is not among them."""
    gs = C // G
    wide = [k * gs for k in range(G, 0, -1)
            if G % k == 0 and k * gs * itemsize % _VEC_BYTES == 0
            and k * gs * itemsize <= _GRID_MAX_ROW_BYTES
            and (k * gs == C or k * gs * itemsize >= _LINE_BYTES)]
    narrow = _channel_block(C, G, itemsize)
    return wide, [narrow] if narrow and narrow not in wide else []


def _grid_held(rows_per_cta: int, row_bytes: int, slabs: int):
    """(box_rows, nbox) of the rows a streaming CTA holds: as many as
    _SLAB_PER_CTA takes, in the fewest boxes of at most _BOX_MAX rows, each
    128-byte aligned; None where they would not reach half its rows."""
    most = _SLAB_PER_CTA // (slabs * row_bytes)
    align = 128 // math.gcd(128, row_bytes)
    nbox = min(-(-most // _BOX_MAX), _GRID_MAX_BOXES)
    box_rows = min(most // nbox // align * align, _BOX_MAX)
    if box_rows < 1 or 2 * nbox * box_rows < rows_per_cta:
        return None
    return box_rows, nbox


def _grid_plan_block(B: int, HW: int, C: int, G: int, itemsize: int, slabs: int, cb: int,
                     stream: bool, sms: int):
    """(cost, plan) of the best grid plan for one channel block, or None:
    held whole (every count k <= `sms` of CTAs a unit whose CTAs hold at most
    _SLAB_PER_CTA bytes of slab; only counts that divide the grid where the
    units fill more than one round, unless none fits: every round then
    starts whole units, and no unit waits on CTAs still in an earlier one),
    or with `stream`, for a slab the card does not hold: `sms` CTAs a unit,
    each holding what _SLAB_PER_CTA takes and streaming the rest (at most as
    many rows). See `_grid_plan` for the cost."""
    gs = C // G
    row_bytes = cb * itemsize
    vpr = row_bytes // _VEC_BYTES
    if cb > _BOX_MAX or vpr > _CLUSTER_THREADS:
        return None
    threads = vpr * (_CLUSTER_THREADS // vpr)
    units = B * (C // cb)

    def cost(plan, streamed):
        rounds = -(-units * plan.cluster // plan.grid)
        sm_bytes = (plan.rows_per_cta * (slabs + 1) + streamed * slabs // 2) * row_bytes
        merge = _GRID_MERGE_WEIGHT * plan.cluster * 2 * cb * 4
        return rounds * (sm_bytes + _GRID_ROUND_BYTES + merge)

    if stream:
        rows_per_cta = -(-HW // sms)
        held = _grid_held(rows_per_cta, row_bytes, slabs)
        if held is None or held[0] * held[1] >= rows_per_cta:
            return None
        smem = _grid_smem(itemsize, cb, gs, *held, threads, slabs == 2)
        ranks = -(-HW // rows_per_cta)
        plan = Plan("grid", cb, ranks, rows_per_cta, *held, threads, smem,
                    min(sms, units * ranks))
        return cost(plan, rows_per_cta - held[0] * held[1]), plan
    best = {}  # aligned or not -> (cost, plan)
    for k in range(1, sms + 1):
        box = _grid_box(HW, k, row_bytes)
        if box is None:
            continue
        box_rows, nbox, rows_per_cta, ranks = box
        smem = _grid_smem(itemsize, cb, gs, box_rows, nbox, threads, slabs == 2)
        if slabs * rows_per_cta * row_bytes > _SLAB_PER_CTA or smem > _SMEM_PER_CTA:
            continue
        plan = Plan("grid", cb, ranks, rows_per_cta, box_rows, nbox, threads, smem,
                    min(sms, units * ranks))
        aligned = plan.grid % ranks == 0
        c = cost(plan, 0)
        if aligned not in best or c < best[aligned][0]:
            best[aligned] = (c, plan)
    return best.get(True, best.get(False))


def _grid_plan(B: int, HW: int, C: int, G: int, itemsize: int, slabs: int, sms: int = _SMS):
    """The grid plan for `slabs` tensors of [H*W, cb] per unit (image, channel
    block), or None where none fits: one CTA an SM (two measured slower at
    every stem row, PERF.md), the grid every SM (or one CTA a (unit, rank)
    pair, if fewer). Over the blocks of `_grid_blocks`, held whole in shared
    memory or, where no block of whole lines or pixels is held whole, such a
    block streaming (a strided block narrower than a line measured slower
    streaming than the four-kernel design, PERF.md): the plan of least cost,
    ties to the earlier block. The cost is what an SM takes: rounds of pairs
    times the bytes it reads and writes a round (streamed rows read again,
    half of them from the L2), plus _GRID_ROUND_BYTES, plus the unit's
    partials each CTA adds (_GRID_MERGE_WEIGHT times their bytes). Only
    shapes that K1's own block cuts (at least _MIN_ROW_BYTES a pixel in whole
    groups) take the design, as the cluster design."""
    if C * itemsize % _VEC_BYTES or not _channel_block(C, G, itemsize):
        return None
    wide, narrow = _grid_blocks(C, G, itemsize)
    whole = [_grid_plan_block(B, HW, C, G, itemsize, slabs, cb, False, sms) for cb in wide]
    if not any(whole):
        whole += [_grid_plan_block(B, HW, C, G, itemsize, slabs, cb, True, sms) for cb in wide]
    found = [f for f in whole + [_grid_plan_block(B, HW, C, G, itemsize, slabs, cb, False, sms)
                                 for cb in narrow] if f is not None]
    return min(found, key=lambda f: f[0])[1] if found else None


@functools.lru_cache(maxsize=None)
def _plan(B: int, H: int, W: int, C: int, G: int, dtype, sms: int = _SMS) -> Plan:
    """Pick K1's design for one shape on a card of `sms` SMs: pure
    arithmetic on the shape.

    "cluster" when the slab of one (image, channel block), H*W*cb*itemsize,
    fits a cluster of at most 8 CTAs: the smallest cluster whose CTAs are
    small enough that two share an SM (about 100 KB of slab each), else the
    smallest whose CTAs hold at most 200 KB of slab (one CTA per SM).
    "grid" when it fits at most `sms` CTAs of at most 200 KB, or twice that
    with half of it streamed (`_grid_plan`). Everything else runs
    "three_pass"."""
    plan = _cluster_plan(H * W, C, G, dtype.itemsize, 1, _cluster_smem)
    plan = plan or _grid_plan(B, H * W, C, G, dtype.itemsize, 1, sms=sms)
    return plan or _THREE_PASS


@functools.lru_cache(maxsize=None)
def _plan_backward(B: int, H: int, W: int, C: int, G: int, dtype, sms: int = _SMS) -> Plan:
    """Pick K1-bwd's design for one shape, as `_plan` does for K1, with the
    slab of x and that of dy held together: "cluster" where both fit a
    cluster of at most 8 CTAs, else of 16 (at most 200 KB of the two a
    CTA); "grid" where they fit `sms` CTAs, or twice that with half of it
    streamed (in whole lines or pixels); "four_kernel" elsewhere."""
    plan = _cluster_plan(H * W, C, G, dtype.itemsize, 2, _cluster_backward_smem,
                         (_CLUSTER_SIZES, _CLUSTER_SIZES_NON_PORTABLE))
    plan = plan or _grid_plan(B, H * W, C, G, dtype.itemsize, 2, sms)
    return plan or _FOUR_KERNEL


class ShardPlan(NamedTuple):
    """How the four cross-shard entries cut one shard (see `_shard_plan`)."""
    cb: int             # channels per reduction CTA: whole groups
    cluster: int        # CTAs per cluster of the two reductions, one per (image, channel block)
    rows_per_cta: int   # rows each reduction CTA sums (the last CTA may sum fewer)
    threads: int        # threads per reduction CTA
    smem_bytes: int     # dynamic shared memory of a reduction CTA
    apply_cb: int       # channels per CTA of the two applies: whole groups, whole rows if they fit
    apply_rows: int     # rows each apply CTA takes (the last may take fewer)
    apply_threads: int  # threads per apply CTA


def _shard_smem(itemsize: int, cb: int, threads: int, cluster: int) -> int:
    """Dynamic shared memory of one reduction CTA: the reduction scratch, its
    own two sums per channel, every rank's (pushed into rank 0) and the
    channels' pivots (the kernels' layout)."""
    return 4 * (2 * _red_slots(cb, itemsize, threads) * cb + 3 * cb + 2 * cluster * cb)


def _group_blocks(C: int, G: int, itemsize: int):
    """Channel blocks of whole groups in whole 16-byte vectors that a CTA's
    row spans (at most _SHARD_MAX_VECTORS), narrowest first."""
    gs = C // G
    return [k * gs for k in range(1, G + 1)
            if G % k == 0 and k * gs * itemsize % _VEC_BYTES == 0
            and k * gs * itemsize // _VEC_BYTES <= _SHARD_MAX_VECTORS]


@functools.lru_cache(maxsize=None)
def _shard_plan(B: int, HW: int, C: int, G: int, dtype, tensors: int = 1):
    """The geometry of the cross-shard kernels for a shard of B images of HW
    rows and C channels in G groups, the reduction reading `tensors` tensors
    (1: the statistics, 2: the backward's sums): pure arithmetic on the
    shape, None where no plan fits (a group wider than 256 vectors of 16
    bytes, or no rows).

    The reduction runs one cluster per (image, channel block). The channel
    block is the widest of whole groups (at least 64 bytes a pixel) for
    which clusters of 16 reach _SHARD_GRID CTAs, else the narrowest; the
    cluster is the smallest that reaches it, or whose CTAs hold no more rows
    than they have row slots (the shared memory within 227 KB). Each CTA
    takes _SHARD_LOADS / tensors / CTAs threads, within _SHARD_THREADS:
    about as many loads in flight on the card for x alone as for x and dy;
    a multiple of 32 where a row's vectors divide a warp.
    The applies: whole rows where they fit a CTA's threads, else the widest
    block of whole groups that does; row ranges enough for
    _SHARD_APPLY_GRID CTAs, at least one row a row slot."""
    item = dtype.itemsize
    blocks = _group_blocks(C, G, item)
    if HW < 1 or not blocks:
        return None
    wide = [k for k in blocks if k * item >= _MIN_ROW_BYTES] or blocks[-1:]
    fits = [k for k in wide if B * (C // k) * _SHARD_CLUSTER_SIZES[-1] >= _SHARD_GRID]
    cb = fits[-1] if fits else wide[0]
    vpr = cb * item // _VEC_BYTES
    # whole rows of threads; whole warps too where a warp holds whole rows,
    # whose shuffles (the kernels' stage_slots) span all 32 lanes
    step = _WARP if _WARP % vpr == 0 else vpr
    pairs = B * (C // cb)
    plan = None
    for cs in _SHARD_CLUSTER_SIZES:
        rows = -(-HW // cs)
        cluster = -(-HW // rows)  # every CTA holds rows
        want = min(max(_SHARD_LOADS // tensors // (pairs * cluster), _SHARD_THREADS[0]),
                   _SHARD_THREADS[1])
        threads = step * max(1, want // step)
        smem = _shard_smem(item, cb, threads, cluster)
        if smem > _SMEM_PER_CTA:
            break
        plan = (cluster, rows, threads, smem)
        if pairs * cluster >= _SHARD_GRID or rows <= threads // vpr:
            break
    if plan is None:
        return None
    apply_cb = blocks[-1]
    avpr = apply_cb * item // _VEC_BYTES
    apply_threads = avpr * (_SHARD_APPLY_THREADS // avpr)
    apairs = B * (C // apply_cb)
    chunks = max(1, min(HW // (apply_threads // avpr), -(-_SHARD_APPLY_GRID // apairs)))
    return ShardPlan(cb, *plan, apply_cb, -(-HW // chunks), apply_threads)


def _chunking(B: int, HW: int):
    nchunks = max(1, min(HW, -(-_TARGET_STATS_BLOCKS // B)))
    chunk_rows = -(-HW // nchunks)
    return chunk_rows, -(-HW // chunk_rows)


def _lib():
    """The kernel library, with its C signatures set once at load."""
    global _LIB
    if _LIB is None:
        from ._build import library

        lib = library("groupnorm")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.crossloc_gn_forward.argtypes = [p] * 7 + [i] * 6 + [ctypes.c_float, i, i, p]
        lib.crossloc_gn_forward.restype = i
        lib.crossloc_gn_cluster_forward.argtypes = [p] * 5 + [i] * 11 + [ctypes.c_float, i, i, p]
        lib.crossloc_gn_cluster_forward.restype = i
        lib.crossloc_gn_backward.argtypes = [p] * 11 + [i] * 8 + [p]
        lib.crossloc_gn_backward.restype = i
        lib.crossloc_gn_cluster_backward.argtypes = [p] * 9 + [i] * 13 + [p]
        lib.crossloc_gn_cluster_backward.restype = i
        lib.crossloc_gn_grid_forward.argtypes = [p] * 6 + [i] * 12 + [ctypes.c_float, i, i, p]
        lib.crossloc_gn_grid_forward.restype = i
        lib.crossloc_gn_grid_backward.argtypes = [p] * 9 + [i] * 14 + [p]
        lib.crossloc_gn_grid_backward.restype = i
        lib.crossloc_gn_shard_stats.argtypes = [p] * 2 + [i] * 10 + [p]
        lib.crossloc_gn_shard_stats.restype = i
        lib.crossloc_gn_shard_apply.argtypes = [p] * 6 + [i] * 8 + [ctypes.c_float, i, i, p]
        lib.crossloc_gn_shard_apply.restype = i
        lib.crossloc_gn_shard_backward_sums.argtypes = [p] * 6 + [i] * 11 + [p]
        lib.crossloc_gn_shard_backward_sums.restype = i
        lib.crossloc_gn_shard_backward_apply.argtypes = [p] * 9 + [i] * 12 + [p]
        lib.crossloc_gn_shard_backward_apply.restype = i
        lib.crossloc_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check_cuda(x, scale, bias) -> None:
    """Raise on any CUDA input the kernels do not take."""
    for name, t in (("scale", scale), ("bias", bias)):
        if t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor on {x.device}")
    _check_cuda_x(x)


def _check_cuda_x(x) -> None:
    """Raise on any CUDA activation the kernels do not take."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"groupnorm kernel takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("groupnorm kernel takes a contiguous NHWC tensor")
    C = x.shape[-1]
    vec = _VEC_BYTES // x.element_size()
    if C % vec != 0 or C // vec > 1024:
        raise ValueError(f"groupnorm kernel needs C % {vec} == 0 and C <= {1024 * vec}, got {C}")
    if x.data_ptr() % _VEC_BYTES != 0:
        raise ValueError("groupnorm kernel needs a 16-byte aligned input")
    if x.numel() >= 2**31:
        raise ValueError("groupnorm kernel indexes with 32-bit ints per image")


def _raise_on(err: int, lib, design: str) -> None:
    if err != 0:
        msg = lib.crossloc_cuda_error_string(err).decode()
        raise RuntimeError(f"groupnorm {design} launch failed: error {err} ({msg})")


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def _three_pass(x, scale, bias, groups: int, eps: float, relu: bool, stats=None):
    """The three-pass design on x's stream: stats, finalize, apply (three
    kernels, a scratch of partials). `_plan` sends slabs too large for the
    card's shared memory here; called directly, it takes every shape (for
    comparisons).
    A float32 `stats` [B, groups, 2] receives (mu, rstd) per (image, group)."""
    _check_cuda(x, scale, bias)
    lib = _lib()
    B, H, W, C = x.shape
    HW = H * W
    chunk_rows, nchunks = _chunking(B, HW)
    y = torch.empty_like(x)
    part = torch.empty(B * nchunks * 2 * C, device=x.device, dtype=torch.float32)
    affine = torch.empty(B * 3 * C, device=x.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.crossloc_gn_forward(
            x.data_ptr(), y.data_ptr(), scale.data_ptr(), bias.data_ptr(), part.data_ptr(),
            affine.data_ptr(), _ptr(stats), B, HW, C, groups, chunk_rows, nchunks, float(eps),
            int(relu), int(x.dtype == torch.bfloat16), stream)
    _raise_on(err, lib, "three-pass")
    group_norm_relu.launches += 1
    return y


def _cluster(x, scale, bias, groups: int, eps: float, relu: bool, plan: Plan, stats=None):
    """The cluster design on x's stream: one launch, x read once, no scratch."""
    lib = _lib()
    B, H, W, C = x.shape
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.crossloc_gn_cluster_forward(
            x.data_ptr(), y.data_ptr(), scale.data_ptr(), bias.data_ptr(), _ptr(stats), B, H * W,
            C, groups, plan.cb, plan.cluster, plan.rows_per_cta, plan.box_rows, plan.nbox,
            plan.threads, plan.smem_bytes, float(eps), int(relu), int(x.dtype == torch.bfloat16),
            stream)
    _raise_on(err, lib, "cluster")
    group_norm_relu.launches += 1
    return y


def _grid(x, scale, bias, groups: int, eps: float, relu: bool, plan: Plan, stats=None):
    """The grid design on x's stream: one cooperative launch, x read once; a
    scratch of each rank's two sums per channel and one arrival counter a
    unit, which the kernel sets to 0 itself."""
    lib = _lib()
    B, H, W, C = x.shape
    units = B * (C // plan.cb)
    y = torch.empty_like(x)
    scratch = torch.empty(units * (plan.cluster * 2 * plan.cb + 1), device=x.device,
                          dtype=torch.float32)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.crossloc_gn_grid_forward(
            x.data_ptr(), y.data_ptr(), scale.data_ptr(), bias.data_ptr(), _ptr(stats),
            scratch.data_ptr(), B, H * W, C, groups, plan.cb, plan.cluster, plan.rows_per_cta,
            plan.box_rows, plan.nbox, plan.threads, plan.smem_bytes, plan.grid, float(eps),
            int(relu), int(x.dtype == torch.bfloat16), stream)
    _raise_on(err, lib, "grid")
    group_norm_relu.launches += 1
    return y


def _sms(x) -> int:
    return torch.cuda.get_device_properties(x.device).multi_processor_count


def _launch(x, scale, bias, groups: int, eps: float, relu: bool, stats=None):
    """Launch K1 on x's stream in the design `_plan` picks. Raises on any
    input it does not take; a failed launch raises, it never falls back."""
    _check_cuda(x, scale, bias)
    B, H, W, C = x.shape
    plan = _plan(B, H, W, C, groups, x.dtype, _sms(x))
    if plan.design == "cluster":
        return _cluster(x, scale, bias, groups, eps, relu, plan, stats)
    if plan.design == "grid":
        return _grid(x, scale, bias, groups, eps, relu, plan, stats)
    return _three_pass(x, scale, bias, groups, eps, relu, stats)


def _forward(x, scale, bias, groups: int, eps: float, relu: bool):
    if x.is_cuda:
        return _launch(x, scale, bias, groups, eps, relu)
    if x.device.type == "cpu":
        return group_norm_relu_plain(x, scale, bias, groups, eps, relu)
    raise ValueError(f"no groupnorm for device {x.device}")


def group_norm_relu_backward_plain(x, scale, bias, dy, groups: int, eps: float = GN_EPS,
                                   relu: bool = True):
    """(dx, dscale, dbias) of `group_norm_relu_plain` at (x, scale, bias) for
    the output gradient dy: its autograd, recomputing the forward (the JAX
    `_bwd`). dx in x's dtype, dscale and dbias float32."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (x, scale, bias)]
        y = group_norm_relu_plain(*leaves, groups, eps, relu)
        return torch.autograd.grad(y, leaves, dy)


def _check_backward(x, scale, bias, stats, dy, groups: int) -> None:
    """Raise on any CUDA input the backward kernels do not take."""
    _check(x, scale, bias, groups)
    _check_cuda(x, scale, bias)
    B = x.shape[0]
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} on {dy.device} does not match x "
                         f"{tuple(x.shape)} {x.dtype} on {x.device}")
    if not dy.is_contiguous() or dy.data_ptr() % _VEC_BYTES != 0:
        raise ValueError("groupnorm backward takes a contiguous, 16-byte aligned NHWC dy")
    if (stats.shape != (B, groups, 2) or stats.dtype != torch.float32
            or stats.device != x.device or not stats.is_contiguous()):
        raise ValueError(f"stats must be a contiguous float32 [{B}, {groups}, 2] on {x.device}")


def _four_kernel_backward(x, scale, bias, stats, dy, groups: int, relu: bool = True):
    """The four-kernel backward on x's stream: per-chunk partials, per-image
    sums, the group coefficients with dscale and dbias, dx (x and dy read
    twice). `_plan_backward` sends slabs too large for the card's shared
    memory here; called directly, it takes every shape (for comparisons)."""
    _check_backward(x, scale, bias, stats, dy, groups)
    lib = _lib()
    B, H, W, C = x.shape
    HW = H * W
    chunk_rows, nchunks = _chunking(B, HW)
    dx = torch.empty_like(x)
    dscale = torch.empty(C, device=x.device, dtype=torch.float32)
    dbias = torch.empty(C, device=x.device, dtype=torch.float32)
    part = torch.empty(B * nchunks * 2 * C, device=x.device, dtype=torch.float32)
    sums = torch.empty(B * 2 * C, device=x.device, dtype=torch.float32)
    table = torch.empty(B * 5 * C, device=x.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.crossloc_gn_backward(
            x.data_ptr(), dy.data_ptr(), scale.data_ptr(), bias.data_ptr(), stats.data_ptr(),
            dx.data_ptr(), dscale.data_ptr(), dbias.data_ptr(), part.data_ptr(),
            sums.data_ptr(), table.data_ptr(), B, HW, C, groups, chunk_rows, nchunks,
            int(relu), int(x.dtype == torch.bfloat16), stream)
    _raise_on(err, lib, "four-kernel backward")
    group_norm_relu_backward.launches += 1
    return dx, dscale, dbias


def _cluster_backward(x, scale, bias, stats, dy, groups: int, relu: bool, plan: Plan):
    """The cluster backward on x's stream: one cluster launch that reads x
    and dy once, then the images' per-channel sums added in order into
    dscale and dbias."""
    lib = _lib()
    B, H, W, C = x.shape
    dx = torch.empty_like(x)
    dscale = torch.empty(C, device=x.device, dtype=torch.float32)
    dbias = torch.empty(C, device=x.device, dtype=torch.float32)
    sums = torch.empty(B * 2 * C, device=x.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.crossloc_gn_cluster_backward(
            x.data_ptr(), dy.data_ptr(), scale.data_ptr(), bias.data_ptr(), stats.data_ptr(),
            dx.data_ptr(), dscale.data_ptr(), dbias.data_ptr(), sums.data_ptr(), B, H * W, C,
            groups, plan.cb, plan.cluster, plan.rows_per_cta, plan.box_rows, plan.nbox,
            plan.threads, plan.smem_bytes, int(relu), int(x.dtype == torch.bfloat16), stream)
    _raise_on(err, lib, "cluster backward")
    group_norm_relu_backward.launches += 1
    return dx, dscale, dbias


def _grid_backward(x, scale, bias, stats, dy, groups: int, relu: bool, plan: Plan):
    """The grid backward on x's stream: one cooperative launch that reads x
    and dy once, then the images' per-channel sums added in order into
    dscale and dbias; one scratch of those sums, each rank's per-channel
    sums and one arrival counter a unit."""
    lib = _lib()
    B, H, W, C = x.shape
    units = B * (C // plan.cb)
    dx = torch.empty_like(x)
    dscale = torch.empty(C, device=x.device, dtype=torch.float32)
    dbias = torch.empty(C, device=x.device, dtype=torch.float32)
    scratch = torch.empty(B * 2 * C + units * (plan.cluster * 2 * plan.cb + 1),
                          device=x.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.crossloc_gn_grid_backward(
            x.data_ptr(), dy.data_ptr(), scale.data_ptr(), bias.data_ptr(), stats.data_ptr(),
            dx.data_ptr(), dscale.data_ptr(), dbias.data_ptr(), scratch.data_ptr(), B, H * W, C,
            groups, plan.cb, plan.cluster, plan.rows_per_cta, plan.box_rows, plan.nbox,
            plan.threads, plan.smem_bytes, plan.grid, int(relu), int(x.dtype == torch.bfloat16),
            stream)
    _raise_on(err, lib, "grid backward")
    group_norm_relu_backward.launches += 1
    return dx, dscale, dbias


def group_norm_relu_backward(x, scale, bias, stats, dy, groups: int, relu: bool = True):
    """K1's backward on x's stream, in the design `_plan_backward` picks:
    (dx, dscale, dbias) from x, the forward's `stats` (float32 [B, groups,
    2] of mu, rstd) and dy (x's dtype, shape and layout). Raises on any
    input it does not take, including a non-contiguous dy; a failed launch
    raises, it never falls back."""
    _check_backward(x, scale, bias, stats, dy, groups)
    B, H, W, C = x.shape
    plan = _plan_backward(B, H, W, C, groups, x.dtype, _sms(x))
    if plan.design == "cluster":
        return _cluster_backward(x, scale, bias, stats, dy, groups, relu, plan)
    if plan.design == "grid":
        return _grid_backward(x, scale, bias, stats, dy, groups, relu, plan)
    return _four_kernel_backward(x, scale, bias, stats, dy, groups, relu)


group_norm_relu_backward.launches = 0  # backward kernel launches (CUDA calls only)


class _GroupNormReLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, groups, eps, relu):
        ctx.cfg = (groups, eps, relu)
        if x.is_cuda:
            stats = torch.empty(x.shape[0], groups, 2, device=x.device, dtype=torch.float32)
            y = _launch(x, scale, bias, groups, eps, relu, stats)
            ctx.save_for_backward(x, scale, bias, stats)
            return y
        ctx.save_for_backward(x, scale, bias)
        return _forward(x, scale, bias, groups, eps, relu)

    @staticmethod
    def backward(ctx, g):
        x, scale, bias, *stats = ctx.saved_tensors
        groups, eps, relu = ctx.cfg
        if x.is_cuda:
            grads = group_norm_relu_backward(x, scale, bias, stats[0], g.contiguous(), groups,
                                             relu)
        else:
            grads = group_norm_relu_backward_plain(x, scale, bias, g, groups, eps, relu)
        return (*grads, None, None, None)


def group_norm_relu(x, scale, bias, groups: int = 32, eps: float = GN_EPS, relu: bool = True):
    """GroupNorm(+ReLU) over NHWC `x` [B, H, W, C] with fp32 `scale`/`bias` [C].

    CUDA tensors launch kernel K1 (and count one launch); CPU tensors take
    the plain version. Differentiable: on CUDA the backward kernel (counted
    on `group_norm_relu_backward.launches`), on the CPU the plain autograd."""
    _check(x, scale, bias, groups)
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad or bias.requires_grad):
        return _GroupNormReLU.apply(x, scale, bias, groups, eps, relu)
    return _forward(x, scale, bias, groups, eps, relu)


group_norm_relu.launches = 0  # kernel launches (CUDA calls); CPU calls never count


# -- the cross-shard form ------------------------------------------------------


def _is_cpu(x) -> bool:
    """True for a CPU tensor (the twin runs), False for a CUDA one (the
    kernel runs); raises for any other device."""
    if x.device.type in ("cpu", "cuda"):
        return x.device.type == "cpu"
    raise ValueError(f"no groupnorm for device {x.device}")


def _check_shard(x, groups: int) -> None:
    if x.dim() != 4:
        raise ValueError(f"expected NHWC input, got shape {tuple(x.shape)}")
    if groups < 1 or x.shape[-1] % groups != 0:
        raise ValueError(f"channels {x.shape[-1]} are not divisible into {groups} groups")


def _check_gathered(gathered, x, shape) -> None:
    """The all-gathered statistics or sums: float32 [S, *shape] on x's device."""
    if (gathered.dim() != len(shape) + 1 or tuple(gathered.shape[1:]) != tuple(shape)
            or gathered.dtype != torch.float32 or gathered.device != x.device
            or not gathered.is_contiguous()):
        raise ValueError(f"expected a contiguous float32 [S, {', '.join(map(str, shape))}] on "
                         f"{x.device}, got {tuple(gathered.shape)} {gathered.dtype} on "
                         f"{gathered.device}")


def _per_channel(t, C: int):
    """[B, G] -> [B, 1, 1, C], each group's value on its channels."""
    return t.repeat_interleave(C // t.shape[1], dim=1)[:, None, None, :]


def group_norm_shard_stats_plain(x, groups: int):
    """Plain twin of K1-shard-stats: float32 [B, groups, 3] of (count, mean,
    M2) per (image, group) over this shard's rows, M2 the centred sum of
    squares."""
    B, H, W, C = x.shape
    xf = x.float().reshape(B, H * W, groups, C // groups)
    mean = xf.mean(dim=(1, 3))
    m2 = (xf - mean[:, None, :, None]).square().sum(dim=(1, 3))
    return torch.stack([torch.full_like(mean, float(H * W * (C // groups))), mean, m2], dim=-1)


def _merge_shard_stats(gathered):
    """(mean, var) [B, G] of [S, B, G, 3] (count, mean, M2) merged with
    Chan's formula in rank order, var clamped at 0."""
    n, mean, m2 = gathered[0].unbind(-1)
    for part in gathered[1:]:
        nb, mb, qb = part.unbind(-1)
        total = n + nb
        delta = mb - mean
        wb = nb / total
        mean = mean + delta * wb
        m2 = m2 + qb + delta * delta * n * wb
        n = total
    return mean, torch.clamp(m2 / n, min=0.0)


def group_norm_shard_apply_plain(x, scale, bias, gathered, groups: int, eps: float = GN_EPS,
                                 relu: bool = True):
    """Plain twin of K1-shard-apply: (y, stats) of this shard's rows from
    every rank's `group_norm_shard_stats` ([S, B, groups, 3], merged in rank
    order); stats is float32 [B, groups, 2] of (mu, rstd)."""
    B, H, W, C = x.shape
    mean, var = _merge_shard_stats(gathered.float())
    rstd = torch.rsqrt(var + eps)
    xf = x.float().reshape(B, H * W, groups, C // groups)
    y = ((xf - mean[:, None, :, None]) * rstd[:, None, :, None]).reshape(B, H, W, C)
    y = y * scale.float() + bias.float()
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype), torch.stack([mean, rstd], dim=-1)


def _masked_grad(x, scale, bias, stats, dy, relu: bool):
    """(x - mu, rstd per channel, gh): gh is dy where the forward's ReLU
    passed, in float32."""
    C = x.shape[-1]
    mu, r = _per_channel(stats[..., 0], C), _per_channel(stats[..., 1], C)
    d = x.float() - mu
    gh = dy.float()
    if relu:
        gh = torch.where(d * (scale.float() * r) + bias.float() > 0, gh, torch.zeros_like(gh))
    return d, r, gh


def group_norm_shard_backward_sums_plain(x, scale, bias, stats, dy, groups: int,
                                         relu: bool = True):
    """Plain twin of K1-bwd-shard-sums: float32 [B, 2, C], per (image,
    channel) the sums over this shard's rows of gh and gh * xhat."""
    del groups  # the stats carry them
    d, r, gh = _masked_grad(x, scale, bias, stats, dy, relu)
    return torch.stack([gh.sum(dim=(1, 2)), (gh * d * r).sum(dim=(1, 2))], dim=1)


def group_norm_shard_backward_apply_plain(x, scale, bias, stats, dy, gathered, index: int,
                                          groups: int, count_hw: int, relu: bool = True):
    """Plain twin of K1-bwd-shard-apply: (dx, dscale, dbias) from every
    rank's `group_norm_shard_backward_sums` ([S, B, 2, C], added in rank
    order); `count_hw` is the whole image's H*W. dscale and dbias are this
    shard's part (rank `index`'s sums over its images)."""
    B, H, W, C = x.shape
    sums = gathered[0]
    for part in gathered[1:]:
        sums = sums + part
    n = count_hw * (C // groups)
    g = scale.float()
    c1 = (g * sums[:, 0]).reshape(B, groups, -1).sum(-1) / n
    c2 = (g * sums[:, 1]).reshape(B, groups, -1).sum(-1) / n
    d, r, gh = _masked_grad(x, scale, bias, stats, dy, relu)
    dx = (g * r) * gh - r * _per_channel(c1, C) - d * r * r * _per_channel(c2, C)
    own = gathered[index]
    return dx.to(x.dtype), own[:, 1].sum(0), own[:, 0].sum(0)


def _stream(x) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _shard_plan_for(x, groups: int, tensors: int) -> ShardPlan:
    """`_shard_plan` of a CUDA shard, or a ValueError where none fits."""
    B, H, W, C = x.shape
    plan = _shard_plan(B, H * W, C, groups, x.dtype, tensors)
    if plan is None:
        raise ValueError(f"no cross-shard plan fits {tuple(x.shape)} {x.dtype} in {groups} "
                         f"groups (a group wider than {_SHARD_MAX_VECTORS} vectors of "
                         f"{_VEC_BYTES} bytes, or no rows)")
    return plan


def group_norm_shard_stats(x, groups: int):
    """K1-shard-stats: float32 [B, groups, 3] (count, mean, M2) of this
    shard's rows; one cluster kernel on a CUDA tensor (one launch counted),
    the twin on a CPU tensor."""
    _check_shard(x, groups)
    if _is_cpu(x):
        return group_norm_shard_stats_plain(x, groups)
    _check_cuda_x(x)
    plan = _shard_plan_for(x, groups, 1)
    lib = _lib()
    B, H, W, C = x.shape
    out = torch.empty(B, groups, 3, device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        err = lib.crossloc_gn_shard_stats(
            x.data_ptr(), out.data_ptr(), B, H * W, C, groups, plan.cb, plan.cluster,
            plan.rows_per_cta, plan.threads, plan.smem_bytes, int(x.dtype == torch.bfloat16),
            _stream(x))
    _raise_on(err, lib, "shard stats")
    group_norm_shard_stats.launches += 1
    return out


def group_norm_shard_apply(x, scale, bias, gathered, groups: int, eps: float = GN_EPS,
                           relu: bool = True):
    """K1-shard-apply: (y, stats [B, groups, 2] of (mu, rstd)) of this
    shard's rows from every rank's statistics `gathered` [S, B, groups, 3];
    one kernel on a CUDA tensor (one launch counted), the twin on a CPU
    tensor."""
    _check(x, scale, bias, groups)
    _check_gathered(gathered, x, (x.shape[0], groups, 3))
    if _is_cpu(x):
        return group_norm_shard_apply_plain(x, scale, bias, gathered, groups, eps, relu)
    _check_cuda(x, scale, bias)
    plan = _shard_plan_for(x, groups, 1)
    lib = _lib()
    B, H, W, C = x.shape
    y = torch.empty_like(x)
    stats = torch.empty(B, groups, 2, device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        err = lib.crossloc_gn_shard_apply(
            x.data_ptr(), y.data_ptr(), scale.data_ptr(), bias.data_ptr(), gathered.data_ptr(),
            stats.data_ptr(), gathered.shape[0], B, H * W, C, groups, plan.apply_cb,
            plan.apply_rows, plan.apply_threads, float(eps), int(relu),
            int(x.dtype == torch.bfloat16), _stream(x))
    _raise_on(err, lib, "shard apply")
    group_norm_shard_apply.launches += 1
    return y, stats


def group_norm_shard_backward_sums(x, scale, bias, stats, dy, groups: int, relu: bool = True):
    """K1-bwd-shard-sums: float32 [B, 2, C] sums of gh and gh * xhat over
    this shard's rows; one cluster kernel on CUDA tensors (one launch
    counted), the twin on CPU tensors."""
    if _is_cpu(x):
        _check(x, scale, bias, groups)
        return group_norm_shard_backward_sums_plain(x, scale, bias, stats, dy, groups, relu)
    _check_backward(x, scale, bias, stats, dy, groups)
    plan = _shard_plan_for(x, groups, 2)
    lib = _lib()
    B, H, W, C = x.shape
    sums = torch.empty(B, 2, C, device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        err = lib.crossloc_gn_shard_backward_sums(
            x.data_ptr(), dy.data_ptr(), scale.data_ptr(), bias.data_ptr(), stats.data_ptr(),
            sums.data_ptr(), B, H * W, C, groups, plan.cb, plan.cluster, plan.rows_per_cta,
            plan.threads, plan.smem_bytes, int(relu), int(x.dtype == torch.bfloat16), _stream(x))
    _raise_on(err, lib, "shard backward sums")
    group_norm_shard_backward_sums.launches += 1
    return sums


def group_norm_shard_backward_apply(x, scale, bias, stats, dy, gathered, index: int, groups: int,
                                    count_hw: int, relu: bool = True):
    """K1-bwd-shard-apply: (dx, dscale, dbias) of this shard from every
    rank's sums `gathered` [S, B, 2, C], the whole image's `count_hw` = H*W
    and this rank's `index` in the group (its dscale and dbias are the
    shard's part); one kernel on CUDA tensors (one launch counted), the
    twin on CPU tensors."""
    _check_gathered(gathered, x, (x.shape[0], 2, x.shape[-1]))
    if not 0 <= index < gathered.shape[0]:
        raise ValueError(f"rank index {index} outside the group of {gathered.shape[0]}")
    if _is_cpu(x):
        _check(x, scale, bias, groups)
        return group_norm_shard_backward_apply_plain(x, scale, bias, stats, dy, gathered, index,
                                                     groups, count_hw, relu)
    _check_backward(x, scale, bias, stats, dy, groups)
    plan = _shard_plan_for(x, groups, 2)
    lib = _lib()
    B, H, W, C = x.shape
    dx = torch.empty_like(x)
    dscale = torch.empty(C, device=x.device, dtype=torch.float32)
    dbias = torch.empty(C, device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        err = lib.crossloc_gn_shard_backward_apply(
            x.data_ptr(), dy.data_ptr(), scale.data_ptr(), bias.data_ptr(), stats.data_ptr(),
            gathered.data_ptr(), dx.data_ptr(), dscale.data_ptr(), dbias.data_ptr(), index,
            gathered.shape[0], B, H * W, int(count_hw), C, groups, plan.apply_cb,
            plan.apply_rows, plan.apply_threads, int(relu), int(x.dtype == torch.bfloat16),
            _stream(x))
    _raise_on(err, lib, "shard backward apply")
    group_norm_shard_backward_apply.launches += 1
    return dx, dscale, dbias


for _entry in (group_norm_shard_stats, group_norm_shard_apply, group_norm_shard_backward_sums,
               group_norm_shard_backward_apply):
    _entry.launches = 0  # kernel launches on CUDA tensors; CPU calls never count
