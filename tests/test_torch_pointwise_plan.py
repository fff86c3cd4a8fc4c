"""The fused ISP pointwise kernel's launch plan (``kernels/isp_fused.py``
``pointwise_plan``), on the CPU: the tile, the blocks on gridDim.x and
the kernel's decode of them, the span each block stages with 16-byte
accesses, threads and shared bytes.  The kernel itself runs only on the
card (``tests/test_torch_cuda_kernels.py``); what it is launched with is
checked here."""
import re
from pathlib import Path

import numpy as np
import pytest

from repro_torch.kernels import isp_fused as K

CSRC = Path(K.__file__).resolve().parent / "csrc" / "isp_fused.cu"
# [B, H, W, C] as the checks on the card launch it: the tick, ragged and
# tiny frames, a VGA batch, 512x512, Bayer mosaics
FRAMES = [(8, 64, 64, 3), (2, 37, 53, 3), (3, 5, 7, 3), (4, 480, 640, 3),
          (8, 512, 512, 3), (8, 64, 64, 1), (2, 37, 53, 1)]


def _spans(plan, B, H, W, C):
    """(frame, first float, floats) of each block's span of the frame's
    flat H*W*C floats, by the kernel's decode of blockIdx.x: the tile
    fastest, then the frame; the last tile of a frame is cut."""
    blk = np.arange(plan.blocks, dtype=np.int64)
    b = blk // plan.tiles
    first = (blk - b * plan.tiles) * plan.tile * C
    n = np.minimum(plan.tile * C, H * W * C - first)
    return b, first, n


def _head_body_tail(ptr_floats, n):
    """The kernel's split of a span starting ptr_floats floats past a
    16-byte-aligned base: 4-byte lanes to the first 16-byte boundary,
    16-byte accesses, 4-byte lanes at the tail (copy_span)."""
    head = min((4 - ptr_floats % 4) % 4, n)
    body = (n - head) // 4
    return head, body, n - head - 4 * body


@pytest.mark.parametrize("frame", FRAMES)
def test_every_float_in_exactly_one_block(frame):
    B, H, W, C = frame
    plan = K.pointwise_plan(B, H, W, C, 3, 3)
    b, first, n = _spans(plan, B, H, W, C)
    assert (n > 0).all() and (n % C == 0).all()      # whole pixels
    assert (n <= plan.tile * C).all()
    cover = np.zeros((B, H * W * C), dtype=np.int32)
    for bi, f, k in zip(b, first, n):
        cover[bi, f:f + k] += 1
    assert (cover == 1).all()
    assert plan.blocks == B * plan.tiles == B * -(-H * W // plan.tile)


@pytest.mark.parametrize("frame", FRAMES)
def test_spans_split_into_whole_16_byte_accesses(frame):
    """Every span's 16-byte part lies aligned in global memory and, with
    the stage offset by the span's phase, in shared memory; the lanes
    around it are fewer than four floats each."""
    B, H, W, C = frame
    plan = K.pointwise_plan(B, H, W, C, 3, 3)
    for bi, f, k in zip(*_spans(plan, B, H, W, C)):
        start = int(bi) * H * W * C + int(f)     # x's base is aligned
        head, body, tail = _head_body_tail(start, int(k))
        assert head < 4 and tail < 4 and head + 4 * body + tail == k
        assert body == 0 or (start + head) % 4 == 0
        phase = start % 4                        # the stage's offset
        assert (phase + head) % 4 == 0 or head == k
        assert phase + k <= plan.tile * C + 4    # inside the slack


@pytest.mark.parametrize("frame,tile,blocks", [
    ((8, 64, 64, 3), 256, 128),          # the tick: a launch's latency
    ((4, 480, 640, 3), 1024, 1200),      # VGA: bytes
    ((8, 512, 512, 3), 1024, 2048),
    ((65537, 2, 3, 3), 1024, 65537),     # past the old grid caps
    ((65537, 64, 64, 1), 1024, 4 * 65537),
])
def test_blocks_on_grid_x(frame, tile, blocks):
    plan = K.pointwise_plan(*frame, 3, 3)
    assert (plan.tile, plan.blocks) == (tile, blocks)
    assert plan.blocks <= K.GRID_LIMIT
    assert plan.threads == K.POINTWISE_THREADS


def test_tile_puts_two_blocks_on_every_sm_where_it_can():
    for frame in FRAMES:
        plan = K.pointwise_plan(*frame, 3, 3)
        bigger = [t for t in K.POINTWISE_TILES if t > plan.tile]
        B, H, W, _ = frame
        for t in bigger:                 # each larger tile leaves SMs idle
            assert B * -(-H * W // t) < K.MIN_BLOCKS
        assert (plan.blocks >= K.MIN_BLOCKS
                or plan.tile == K.POINTWISE_TILES[-1])


@pytest.mark.parametrize("C,P,S", [(3, 3, 3), (1, 1, 1), (3, 7, 1),
                                   (1, 0, 0)])
def test_shared_bytes_equal_the_kernels(C, P, S):
    """The plan's shared bytes are csrc's pointwise_floats for the tile,
    within the static 48 KB."""
    body = re.search(r"pointwise_floats\(int tile, int C, int P,\s*int S\)"
                     r"\s*\{\s*return ([^;]+);", CSRC.read_text())
    expr = body.group(1).replace("kLut", str(K.LUT_SIZE))
    for tile in K.POINTWISE_TILES:
        want = 4 * eval(expr, {}, dict(tile=tile, C=C, P=P, S=S))
        assert K.pointwise_smem(tile, C, P, S) == want
        assert want <= K.POINTWISE_SMEM_LIMIT
    tiles = re.search(r"tile != (\d+) && tile != (\d+) && tile != (\d+)",
                      CSRC.read_text()).groups()
    assert sorted(map(int, tiles)) == sorted(K.POINTWISE_TILES)
    threads = re.search(r"kPointwiseThreads = (\d+);", CSRC.read_text())
    assert int(threads.group(1)) == K.POINTWISE_THREADS


def test_plan_is_cached_and_refuses_what_it_cannot_launch():
    assert K.pointwise_plan(8, 64, 64, 3, 3, 3) is \
        K.pointwise_plan(8, 64, 64, 3, 3, 3)
    with pytest.raises(ValueError, match="C must be 1 or 3"):
        K.pointwise_plan(8, 64, 64, 2, 3, 3)
    with pytest.raises(ValueError, match="past gridDim.x"):
        K.pointwise_plan(2 ** 31, 1, 1, 1, 1, 1)
    with pytest.raises(ValueError, match="shared bytes"):
        K.pointwise_plan(8, 64, 64, 3, 20000, 1)
