"""The work plan of chamfer.bf16 (ops/csrc/chamfer_bf16.cu), on the CPU.

The kernel runs only on the card; its plan is plain Python
(``kernels.chamfer_bf16_plan``, ``kernels.chamfer_bf16_item``) that the
wrapper passes to it. These tests hold that plan: the persistent blocks
(block k takes items k, k + grid, ...) cover every (pair, query frame, ref
frame) of a call exactly once, at the DnS path's chamfer shapes and at the
card tests' frame counts and depths; the shared memory fits an H100 block;
the B operand's 9 · RT rows are a wgmma width; and the Python mirror's
constants are the kernel source's.
"""

import re

import numpy as np
import pytest

from vsc2022_torch.ops import _build, kernels

# [B, NQ, NR] of the DnS path's chamfer calls (chip_smoke.py phase 5), D = 512.
PATH_SHAPES = [
    (6, 32, 64), (11, 32, 128), (5, 64, 32), (14, 64, 64), (86, 64, 128),
    (9, 128, 32), (68, 128, 64), (256, 128, 128), (45, 128, 128),
]
# The card tests' frame counts (tests/test_torch_cuda.py CHAMFER_FRAMES) and
# depths (those tests' D, and past the resident limit).
FRAMES = [1, 17, 32, 64, 100, 128]
DEPTHS = [8, 24, 512, 1024]


def _coverage(b, nq, nr, d, sms=132):
    """How many times the plan's blocks compute each (pair, query frame,
    ref frame), and the items each block walks."""
    plan = kernels.chamfer_bf16_plan(b, nq, nr, d, sms)
    count = np.zeros((b, nq, nr), dtype=np.int32)
    walked = []
    for k in range(plan.grid):
        items = np.arange(k, plan.items, plan.grid)
        walked.append(len(items))
        pairs, q0s, r0s = kernels.chamfer_bf16_item(items, nq, nr)
        for p, q0, r0 in zip(pairs, q0s, r0s):
            count[p, q0 : q0 + kernels.CHAMFER_QT, r0 : r0 + kernels.CHAMFER_RT] += 1
    return plan, count, walked


def _assert_once(b, nq, nr, d, sms=132):
    plan, count, walked = _coverage(b, nq, nr, d, sms)
    assert plan.items == b * -(-nq // 128) * -(-nr // 16)
    assert plan.grid == min(plan.items, sms)
    assert bool((count == 1).all()), "a frame pair is computed twice or never"
    # One wave of persistent blocks, each with work, at most one item apart.
    assert min(walked) >= 1 and max(walked) - min(walked) <= 1


@pytest.mark.parametrize("b,nq,nr", PATH_SHAPES)
def test_plan_covers_the_path_shapes_once(b, nq, nr):
    _assert_once(b, nq, nr, 512)
    plan = kernels.chamfer_bf16_plan(b, nq, nr, 512)
    assert plan.resident and plan.slots == plan.kt_n == 8


@pytest.mark.parametrize("d", DEPTHS)
@pytest.mark.parametrize("nr", FRAMES)
@pytest.mark.parametrize("nq", FRAMES)
def test_plan_covers_the_card_tests_grid_once(nq, nr, d):
    _assert_once(2, nq, nr, d)


@pytest.mark.parametrize("sms", [1, 7, 132])
def test_plan_covers_more_pairs_than_a_wave_once(sms):
    # The card test's 700 pairs, and the blocks of a smaller card.
    _assert_once(700, 128, 16, 64, sms)
    _assert_once(700, 50, 40, 64, sms)


@pytest.mark.parametrize("d", [8, 64, 512, 520, 576, 1024, 1032, 4096])
def test_plan_fits_shared_memory_and_streams_past_the_resident_limit(d):
    plan = kernels.chamfer_bf16_plan(3, 100, 37, d)
    assert plan.kt_n == -(-d // kernels.CHAMFER_BK)
    assert plan.smem_bytes == kernels.chamfer_bf16_smem_bytes(plan.slots)
    assert plan.smem_bytes <= kernels.CHAMFER_SMEM_LIMIT
    # Resident (one slice a k-slice) up to D = 512, streamed through 8
    # slices beyond: a streamed ring needs two slots at least.
    assert plan.resident == (d <= 512)
    assert plan.slots == (plan.kt_n if plan.resident else kernels.CHAMFER_MAX_SLOTS)
    assert kernels.CHAMFER_MAX_SLOTS == 8
    assert kernels.chamfer_bf16_smem_bytes(kernels.CHAMFER_MAX_SLOTS + 1) > (
        kernels.CHAMFER_SMEM_LIMIT)


def test_the_ref_tile_is_a_wgmma_width():
    # wgmma takes N a multiple of 8 up to 256: the B operand is 9 · RT rows,
    # and the query rows split in two consumers of 64 (wgmma's M).
    n = kernels.CHAMFER_REGIONS * kernels.chamfer_bf16_plan(1, 1, 1, 8).rt
    assert n % 8 == 0 and n <= 256
    assert kernels.CHAMFER_QT == 2 * 64


def test_the_plan_mirrors_the_kernel_source():
    src = (_build.CSRC / "chamfer_bf16.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("RT") == kernels.CHAMFER_RT
    assert const("QT") == kernels.CHAMFER_QT
    assert const("BK") == kernels.CHAMFER_BK
    assert const("kStages") == kernels.CHAMFER_STAGES
    assert const("kMaxSmem") == kernels.CHAMFER_SMEM_LIMIT
    assert const("kAlign") == 1024
    assert "i += gridDim.x" in src  # the strided walk chamfer_bf16_item describes
