"""The fused ISP stencil kernel's launch plan (``kernels/isp_fused.py``
``stencil_plan``), on the CPU: the tile each window op takes, the blocks
on gridDim.x and the kernel's decode of them, threads and shared bytes.
The kernel itself runs only on the card
(``tests/test_torch_cuda_kernels.py``); what it is launched with is
checked here."""
import numpy as np
import pytest

from repro_torch.kernels import isp_fused as K

# (window op, input channels) as the fused orderings launch them; NLM also
# on a mosaic, and on 2 and 4 channels as the standalone NLM kernel
# (csrc/nlm.cu, the same NLM tile) takes them
OPS = [("dpc", 1), ("demosaic", 1), ("nlm", 3), ("nlm", 1), ("sharpen", 3),
       ("nlm", 2), ("nlm", 4)]
FRAMES = [(8, 64, 64), (2, 37, 53), (1, 5, 7), (4, 480, 640)]


def _tiles(plan):
    """(frame, first row, first column) of each block's output tile, by
    the kernel's decode of blockIdx.x: the tile column fastest, then the
    tile row, then the frame."""
    blk = np.arange(plan.blocks, dtype=np.int64)
    rest = blk // plan.tiles_x
    b = rest // plan.tiles_y
    return (b, (rest - b * plan.tiles_y) * plan.th,
            (blk - rest * plan.tiles_x) * plan.tw)


def _coverage(plan, B, H, W):
    """How many blocks write each output pixel (a tile's pixels outside
    the frame are not written)."""
    b, y0, x0 = _tiles(plan)
    cover = np.zeros((B, H + plan.th, W + plan.tw), dtype=np.int32)
    dy, dx = np.meshgrid(np.arange(plan.th), np.arange(plan.tw),
                         indexing="ij")
    np.add.at(cover, (b[:, None, None], y0[:, None, None] + dy,
                      x0[:, None, None] + dx), 1)
    return cover[:, :H, :W], cover


@pytest.mark.parametrize("frame", FRAMES)
@pytest.mark.parametrize("op,c_in", OPS)
def test_every_pixel_in_exactly_one_tile(op, c_in, frame):
    B, H, W = frame
    plan = K.stencil_plan(op, B, H, W, c_in)
    inside, whole = _coverage(plan, B, H, W)
    assert (inside == 1).all()
    assert whole.sum() == plan.blocks * plan.th * plan.tw
    assert plan.blocks == B * plan.tiles_y * plan.tiles_x
    assert plan.tiles_y == -(-H // plan.th)
    assert plan.tiles_x == -(-W // plan.tw)


@pytest.mark.parametrize("frame", FRAMES + [(65537, 8, 8)])
@pytest.mark.parametrize("op,c_in", OPS)
def test_plan_fits_a_block_and_the_grid(op, c_in, frame):
    plan = K.stencil_plan(op, *frame, c_in)
    assert 0 < plan.smem <= K.SMEM_LIMIT
    assert plan.blocks <= K.GRID_LIMIT
    assert plan.threads % 32 == 0 and plan.threads <= 512
    assert (plan.th, plan.tw) in K.op_tiles(op)
    if op == "nlm":
        assert plan.threads == K.NLM_THREADS
    else:
        assert plan.threads == plan.th * plan.tw    # a thread a pixel


@pytest.mark.parametrize("op,c_in", OPS)
def test_tick_frames_put_two_blocks_on_every_sm(op, c_in):
    """NLM at [8, 64, 64] (the tick) and on a VGA batch takes the largest
    tile whose grid still puts two blocks on every SM; dpc, demosaic and
    sharpen have the one 8x32 tile (a thread a pixel)."""
    if op != "nlm":
        assert K.op_tiles(op) == ((8, 32),)
        assert K.stencil_plan(op, 8, 64, 64, c_in).blocks == 128
        return
    for frame in ((8, 64, 64), (4, 480, 640)):
        plan = K.stencil_plan(op, *frame, c_in)
        assert plan.blocks >= K.MIN_BLOCKS
        larger = K.op_tiles(op)[:K.op_tiles(op).index((plan.th, plan.tw))]
        for th, tw in larger:
            assert K.tile_plan(op, *frame, c_in, th, tw).blocks \
                < K.MIN_BLOCKS
    # a frame too small for that takes the smallest tile
    assert (K.stencil_plan(op, 1, 5, 7, c_in)[1:3]
            == K.op_tiles(op)[-1])


@pytest.mark.parametrize("op,c_in", OPS)
def test_shared_bytes_of_each_tile(op, c_in):
    """The window (c_in channels; NLM on RGB a float4 a pixel), the
    luminance plane (NLM, sharpen; its pitch widened where two shift rows
    would share a bank), NLM's weights [shift][pixel] (a shift's row one
    longer than the tile, so the seven shifts a weight thread stores at
    once fall on distinct banks) and the frame's gamma LUT, as csrc
    Layout counts them; NLM's float4 window and the planes after it
    start on 16-byte boundaries."""
    r = K.WINDOW_RADIUS[op]
    for th, tw in K.op_tiles(op):
        wy, wx = th + 2 * r, tw + 2 * r
        want = wy * wx * (4 if op == "nlm" and c_in == 3 else c_in)
        if op == "nlm":     # the NLM tile's planes, without the LUT
            tile = want + wy * K.lum_pitch(wx) + 49 * (th * tw + 1)
            assert K.nlm_tile_smem(c_in, th, tw) == 4 * tile
        if op == "nlm":
            assert want % 4 == 0 and wy * K.lum_pitch(wx) % 4 == 0
        if op in ("nlm", "sharpen"):
            pitch = K.lum_pitch(wx)
            assert pitch >= wx and pitch % 32 != 16
            want += wy * pitch
        if op == "nlm":
            pitch = th * tw + 1
            assert len({7 * k * pitch % 32 for k in range(7)}) == 7
            want += 49 * pitch
        assert K.stencil_smem(op, c_in, th, tw) == 4 * (want + 256)


def test_plan_is_cached_and_refuses_what_it_cannot_launch():
    assert K.stencil_plan("nlm", 8, 64, 64, 3) is K.stencil_plan(
        "nlm", 8, 64, 64, 3)
    with pytest.raises(ValueError, match="no window op"):
        K.stencil_plan("gamma", 1, 8, 8, 3)
    with pytest.raises(ValueError, match="no 32x32 tile"):
        K.tile_plan("dpc", 1, 8, 8, 1, 32, 32)
    with pytest.raises(ValueError, match="gridDim.x"):
        K.tile_plan("dpc", 2 ** 31, 8, 8, 1, 8, 32)
    for op, c_in in (("nlm", 5), ("sharpen", 1), ("dpc", 3)):
        with pytest.raises(ValueError, match="no instance on"):
            K.stencil_plan(op, 1, 8, 8, c_in)


@pytest.mark.parametrize("frame", [(8, 64, 64), (4, 480, 640), (2, 37, 53),
                                   (3, 5, 7), (65537, 6, 10)])
def test_demosaic_plan_has_even_tiles_on_the_grid(frame):
    """The standalone demosaic kernel's plan (the stencil segment's): an
    even tile, so a pixel's Bayer phase in the tile is its phase in the
    frame (every tile's corner even by the kernel's decode), one thread a
    pixel, its window's shared bytes, and every block on gridDim.x."""
    B, H, W = frame
    plan = K.stencil_plan("demosaic", B, H, W, 1)
    assert plan.th % 2 == 0 and plan.tw % 2 == 0
    assert plan.threads == plan.th * plan.tw
    assert plan.blocks == B * -(-H // plan.th) * -(-W // plan.tw)
    assert plan.blocks <= K.GRID_LIMIT
    b, y0, x0 = _tiles(plan)
    assert (y0 % 2 == 0).all() and (x0 % 2 == 0).all()
    assert b[-1] == B - 1
    assert K.demosaic_tile_smem(plan.th, plan.tw) == 4 * (plan.th + 4) * (
        plan.tw + 4)
    assert plan.smem == K.demosaic_tile_smem(plan.th, plan.tw) + 4 * 256


def test_demosaic_plan_refuses_an_odd_tile(monkeypatch):
    monkeypatch.setattr(K, "LIGHT_TILES", ((7, 32),))
    with pytest.raises(ValueError, match="even tile"):
        K.tile_plan("demosaic", 1, 8, 8, 1, 7, 32)
