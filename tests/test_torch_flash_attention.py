"""The port's flash attention (``repro_torch.kernels.flash_attention``)
against the JAX package, and its CUDA kernel against its plain version.

On the CPU: the plain scan against ``repro.kernels.ref.flash_attention_ref``
(1e-5) and against ``flash_attention_pallas`` in interpret mode with
bq = bk = 64 (2e-4, the repo's own bar), on ``tests/test_kernels.py``'s
shapes; the model-layout function against the reference model's
``repro.models.attention.flash_attention`` at 1e-5 in float32 (GQA, a
window, a query offset, a non-causal ragged Sk, dv != d, MLA's (d, dv)
= (192, 128) and reduced MLA's (24, 16)); the wrapper on CPU tensors
takes the plain version, and what it does not take raises.

Also on the CPU: ``kernel_design`` (the kernel a CUDA call runs, from its
type and head dims alone), ``key_range`` against the visibility mask,
``wgmma_schedule`` (every item once, causal tiles longest first, a KV
head's query heads adjacent, the blocks' key tiles even at the prefill
shape) and the refusals of the launcher that need no card.

The ``cuda`` cases need a card and skip here: the kernel against its plain
version on the same inputs, float32 within 1e-5, bfloat16 within the
rounding bound ``bf16_error_bound`` (the kernel rounds the softmax
weights to bf16 for the P.V product on the tensor cores, and both
outputs round to bf16: 2^-8 (A + |got| + |plain|) + 1e-5, A the
attention over |v|), capped at the earlier fixed bar ``BF16_ATOL +
BF16_RTOL * |plain|``; the "wgmma" design at d = dv = 128 (and 64) on
GQA, window, offset, ragged and non-causal cases, each counted on its
design; its two products alone (``wgmma_products``); a 28-layer
prefill with head dim 128 whose every launch runs "wgmma"; small head
dims on "mma_sync"; deepseek-v3's MLA head dims (192, 128) on
"mma_sync" and "f32" (causal, non-causal, ragged, 128 heads).  JAX is imported inside the CPU tests only, so
the ``cuda`` cases run where JAX is absent:

    python -m pytest -q -m cuda tests/test_torch_flash_attention.py
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.flash_attention import (HEAD_DIMS, WGMMA_HEAD_DIMS,
                                                 bf16_error_bound,
                                                 flash_attention,
                                                 flash_attention_plain,
                                                 flash_attention_ref_plain,
                                                 visible_mask)
from repro_torch.models.attention import flash_attention as model_flash

F32_TOL = 1e-5
PALLAS_TOL = 2e-4
BF16_ATOL, BF16_RTOL = 2e-2, 1e-2     # the cap on the bf16 rounding bound

# (BH, Sq, Sk, d) of tests/test_kernels.py::test_flash_attention
KERNEL_SHAPES = [(2, 64, 64, 16), (4, 70, 70, 32), (1, 128, 256, 64)]
# model layout: (B, Sq, Sk, Hq, Hkv, d, dv, causal, q_offset, window)
MODEL_CASES = (
    [(2, 80, 80, 2 * G, 2, 16, 16, True, qo, w)
     for G in (1, 2, 7) for w in (0, 16) for qo in (0, 5)]
    + [(2, 50, 77, 4, 2, 16, 16, False, 0, 0),      # non-causal, ragged Sk
       (1, 40, 100, 4, 4, 32, 32, False, 0, 0),
       (2, 70, 70, 4, 2, 32, 16, True, 0, 0),       # dv != d
       (2, 70, 70, 4, 1, 32, 16, True, 5, 16)])
# the prefill's shape: qwen2-7b, 4096 tokens
FULL_CASE = (1, 4096, 4096, 28, 4, 128, 128, True, 0, 0)
# MLA's head dims on the CPU: deepseek-v3's (192, 128) and reduced
# deepseek-v3's (24, 16), Hkv = Hq (the RoPE key broadcast over the heads)
MLA_CPU_CASES = [(1, 70, 70, 2, 2, 192, 128, True, 0, 0),
                 (2, 40, 40, 4, 4, 24, 16, True, 0, 0),
                 (1, 30, 50, 2, 2, 192, 128, False, 0, 0)]
# deepseek-v3's MLA prefill on "mma_sync" / "f32": causal, non-causal,
# ragged Sq and Sk, and its 128 heads
MLA_CASES = [
    (2, 256, 256, 4, 4, 192, 128, True, 0, 0),
    (1, 130, 130, 8, 8, 192, 128, True, 0, 0),       # ragged Sq = Sk
    (2, 100, 333, 4, 4, 192, 128, False, 0, 0),      # non-causal, ragged Sk
    (1, 200, 330, 4, 4, 192, 128, True, 130, 0),     # q_offset, Sq != Sk
    (1, 512, 512, 128, 128, 192, 128, True, 0, 0),   # H = Hkv = 128
]
# the "wgmma" design: d = dv = 128 (every full-width LM head), and 64
WGMMA_CASES = [
    (2, 256, 256, 4, 4, 128, 128, True, 0, 0),      # G = 1
    (1, 300, 300, 14, 2, 128, 128, True, 0, 0),     # G = 7
    (1, 400, 400, 7, 1, 128, 128, True, 0, 100),    # a window
    (1, 200, 330, 7, 1, 128, 128, True, 130, 0),    # q_offset, Sq != Sk
    (1, 150, 400, 7, 1, 128, 128, True, 250, 64),   # both
    (2, 130, 130, 4, 2, 128, 128, True, 0, 0),      # ragged Sq = Sk
    (1, 1000, 1000, 7, 1, 128, 128, True, 0, 0),
    (2, 100, 333, 4, 2, 128, 128, False, 0, 0),     # non-causal, ragged Sk
    (1, 384, 200, 4, 1, 128, 128, False, 0, 0),     # Sq > Sk
    (2, 200, 200, 4, 2, 64, 64, True, 0, 0),
    (1, 130, 260, 4, 4, 64, 64, False, 0, 0),
]


def _case_id(c):
    B, Sq, Sk, Hq, Hkv, d, dv, causal, qo, w = c
    return (f"B{B}-S{Sq}x{Sk}-H{Hq}/{Hkv}-d{d}/{dv}-"
            f"{'causal' if causal else 'full'}-qo{qo}-w{w}")


def _inputs(c, seed=0, dtype=np.float32):
    B, Sq, Sk, Hq, Hkv, d, dv, _, _, _ = c
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (B, Sq, Hq, d)).astype(dtype),
            rng.normal(0, 1, (B, Sk, Hkv, d)).astype(dtype),
            rng.normal(0, 1, (B, Sk, Hkv, dv)).astype(dtype))


@pytest.fixture(scope="module")
def jx():
    """The JAX reference, imported here and not at the top of the file."""
    import jax.numpy as jnp

    from repro.kernels import ref
    from repro.kernels.flash_attention import flash_attention_pallas
    from repro.models.attention import flash_attention as jflash
    return types.SimpleNamespace(jnp=jnp, ref=ref.flash_attention_ref,
                                 pallas=flash_attention_pallas, flash=jflash)


# ---------------------------------------------------------------------------
# CPU: the plain versions against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("BH,Sq,Sk,d", KERNEL_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_ref_and_pallas(jx, BH, Sq, Sk, d, causal):
    rng = np.random.default_rng(BH * 1000 + Sq)
    q = rng.normal(0, 1, (BH, Sq, d)).astype(np.float32)
    k = rng.normal(0, 1, (BH, Sk, d)).astype(np.float32)
    v = rng.normal(0, 1, (BH, Sk, d)).astype(np.float32)
    want = np.asarray(jx.ref(jx.jnp.asarray(q), jx.jnp.asarray(k),
                             jx.jnp.asarray(v), causal=causal))
    # the model layout with one head per batch row is the [BH, S, d] one
    got = flash_attention_plain(
        torch.tensor(q)[:, :, None], torch.tensor(k)[:, :, None],
        torch.tensor(v)[:, :, None], causal=causal)[:, :, 0].numpy()
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)
    one_shot = flash_attention_ref_plain(torch.tensor(q), torch.tensor(k),
                                         torch.tensor(v), causal=causal)
    np.testing.assert_allclose(one_shot.numpy(), want, atol=F32_TOL,
                               rtol=F32_TOL)
    if causal or Sk % 64 == 0:   # the Pallas kernel refuses a ragged Sk
        pal = np.asarray(jx.pallas(jx.jnp.asarray(q), jx.jnp.asarray(k),
                                   jx.jnp.asarray(v), causal=causal,
                                   bq=64, bk=64))
        np.testing.assert_allclose(got, pal, atol=PALLAS_TOL)


@pytest.mark.parametrize("case", MODEL_CASES, ids=_case_id)
def test_model_layout_matches_jax(jx, case):
    """The model's function (the wrapper: plain on the CPU) and the plain
    scan at a 32-key block (several blocks at these sizes) against the
    reference model's scan at the same blocks."""
    _, _, _, _, _, _, _, causal, qo, w = case
    q, k, v = _inputs(case)
    jq, jk, jv = (jx.jnp.asarray(a) for a in (q, k, v))
    tq, tk, tv = torch.tensor(q), torch.tensor(k), torch.tensor(v)
    want = np.asarray(jx.flash(jq, jk, jv, causal=causal, q_offset=qo,
                               window=w))
    got = model_flash(tq, tk, tv, causal=causal, q_offset=qo, window=w)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=F32_TOL)
    want32 = np.asarray(jx.flash(jq, jk, jv, causal=causal, q_offset=qo,
                                 window=w, block=32))
    got32 = flash_attention_plain(tq, tk, tv, causal=causal, q_offset=qo,
                                  window=w, block=32)
    np.testing.assert_allclose(got32.numpy(), want32, atol=F32_TOL,
                               rtol=F32_TOL)


@pytest.mark.parametrize("case", MLA_CPU_CASES, ids=_case_id)
def test_mla_head_dims_match_jax(jx, case):
    """The plain scan (the wrapper's CPU path) at MLA's (d, dv) against
    the reference model's scan, the scale d^-0.5 from q's head dim."""
    _, _, _, _, _, _, _, causal, qo, w = case
    q, k, v = _inputs(case, seed=13)
    want = np.asarray(jx.flash(*(jx.jnp.asarray(a) for a in (q, k, v)),
                               causal=causal, q_offset=qo, window=w))
    got = flash_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                          causal=causal, q_offset=qo, window=w)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=F32_TOL)


def test_bf16_plain_returns_q_type(jx):
    """bf16 in, f32 math, bf16 out, as the reference model's scan."""
    case = MODEL_CASES[2]
    q, k, v = _inputs(case)
    bq, bk, bv = (torch.tensor(a).bfloat16() for a in (q, k, v))
    got = flash_attention(bq, bk, bv, causal=True, q_offset=5)
    assert got.dtype == torch.bfloat16
    want = np.asarray(jx.flash(*(jx.jnp.asarray(t.float().numpy())
                                 for t in (bq, bk, bv)),
                               causal=True, q_offset=5))
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-2,
                               rtol=1e-2)


def test_wrapper_on_cpu_takes_the_plain_version():
    case = MODEL_CASES[5]
    q, k, v = (torch.tensor(a) for a in _inputs(case, seed=3))
    build.reset_launches()
    got = flash_attention(q, k, v, causal=True, q_offset=0, window=16)
    want = flash_attention_plain(q, k, v, causal=True, q_offset=0, window=16)
    assert torch.equal(got, want)
    assert build.LAUNCHES["flash_attention"] == 0


def _rounded_weights_attention(q, k, v, hidden_keys=None):
    """The bf16 kernel's rounding on the CPU: f32 scores from bf16 inputs,
    each weight exp(s - m) rounded to bf16 for the P.V product, l summed
    from the f32 weights, the output rounded to bf16; ``hidden_keys``
    (rows, keys) are masked as a faulty kernel would drop them."""
    B, S, Hq, d = q.shape
    G = Hq // k.shape[2]
    kf, vf = (t.float().repeat_interleave(G, dim=2) for t in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * d ** -0.5
    mask = torch.ones(S, S, dtype=torch.bool).tril()
    if hidden_keys is not None:
        mask[hidden_keys] = False
    s = torch.where(mask, s, -1e30)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    o = torch.einsum("bhqk,bkhd->bqhd", p.bfloat16().float(), vf)
    return (o / p.sum(dim=-1).permute(0, 2, 1)[..., None]).bfloat16()


@pytest.mark.parametrize("fault", [None, "dropped tile"])
def test_bf16_bound_holds_for_rounding_and_not_for_a_dropped_tile(fault):
    """``bf16_error_bound`` holds for the kernel's own rounding and fails
    where one 64-key tile is dropped from the late rows."""
    case = (1, 512, 512, 4, 1, 64, 64, True, 0, 0)
    q, k, v = (torch.tensor(a).bfloat16() for a in _inputs(case, seed=7))
    hidden = None if fault is None else (slice(384, None), slice(64, 128))
    got = _rounded_weights_attention(q, k, v, hidden)
    want = flash_attention_plain(q, k, v, causal=True)
    err = (got.float() - want.float()).abs()
    within = err <= bf16_error_bound(q, k, v, got, want, causal=True)
    if fault is None:
        assert bool(within.all())
    else:
        assert not bool(within[:, 384:].all()) and bool(within[:, :384].all())


def _bad_inputs():
    q = torch.zeros(1, 8, 4, 16)
    k = torch.zeros(1, 8, 2, 16)
    return {
        "float64": ((q.double(), k.double(), k.double()), TypeError),
        "float16": ((q.half(), k.half(), k.half()), TypeError),
        "mixed types": ((q, k.bfloat16(), k), TypeError),
        "mixed devices": ((q, k.to("meta"), k), ValueError),
        "meta device": ((q.to("meta"), k.to("meta"), k.to("meta")),
                        ValueError),
        "3-D q": ((q[0], k, k), ValueError),
        "d mismatch": ((q, torch.zeros(1, 8, 2, 32), k), ValueError),
        "k/v lengths": ((q, k, torch.zeros(1, 9, 2, 16)), ValueError),
        "batch": ((q, torch.zeros(2, 8, 2, 16), torch.zeros(2, 8, 2, 16)),
                  ValueError),
        "heads": ((q, torch.zeros(1, 8, 3, 16), torch.zeros(1, 8, 3, 16)),
                  ValueError),
    }


@pytest.mark.parametrize("name", list(_bad_inputs()))
def test_wrapper_raises_on_what_it_does_not_take(name):
    (q, k, v), err = _bad_inputs()[name]
    with pytest.raises(err):
        flash_attention(q, k, v, causal=True)


@pytest.mark.parametrize("dtype,d,dv,want", [
    (torch.bfloat16, 128, 128, "wgmma"), (torch.bfloat16, 64, 64, "wgmma"),
    (torch.bfloat16, 16, 16, "mma_sync"), (torch.bfloat16, 32, 32, "mma_sync"),
    (torch.bfloat16, 32, 16, "mma_sync"), (torch.bfloat16, 192, 128,
                                           "mma_sync"),
    (torch.float32, 128, 128, "f32"), (torch.float32, 192, 128, "f32"),
    (torch.float32, 16, 16, "f32")])
def test_kernel_design_by_type_and_head_dims(dtype, d, dv, want):
    assert fa.kernel_design(dtype, d, dv) == want
    assert (d, dv) in (WGMMA_HEAD_DIMS if want == "wgmma" else HEAD_DIMS)


@pytest.mark.parametrize("Sk,causal,q_offset,window", [
    (300, True, 0, 0), (300, False, 0, 0), (333, True, 130, 0),
    (400, True, 250, 64), (400, True, 0, 100), (90, False, 0, 0)])
def test_key_range_holds_every_visible_key(Sk, causal, q_offset, window):
    """Each 128-row tile's [lo, hi) holds every key a row of it sees, and
    its first and last keys are seen by some row; a tile that sees none
    gets an empty range."""
    Sq = 260
    vis = visible_mask(q_offset + torch.arange(Sq), torch.arange(Sk + 200),
                       Sk=Sk, causal=causal, window=window)
    for q0 in range(0, Sq, fa.WGMMA_BM):
        q1 = min(q0 + fa.WGMMA_BM, Sq)
        lo, hi = fa.key_range(q0, q1, Sk=Sk, causal=causal,
                              q_offset=q_offset, window=window)
        seen = vis[q0:q1].any(dim=0).nonzero().flatten()
        if seen.numel() == 0:        # rows whose window lies past Sk
            assert lo == hi
        else:
            assert int(seen.min()) == lo and int(seen.max()) == hi - 1


SCHEDULES = [(2, 4096, 4096, 28, True, 0, 0, 132),
             (1, 1000, 1000, 7, True, 0, 0, 132),
             (2, 100, 333, 4, False, 0, 0, 132),
             (1, 150, 400, 7, True, 250, 64, 16),
             (3, 700, 700, 6, False, 0, 0, 5)]


@pytest.mark.parametrize("B,Sq,Sk,Hq,causal,q_offset,window,n_blocks",
                         SCHEDULES)
def test_wgmma_schedule_runs_each_item_once(B, Sq, Sk, Hq, causal, q_offset,
                                            window, n_blocks):
    blocks = fa.wgmma_schedule(B, Sq, Sk, Hq, causal=causal,
                               q_offset=q_offset, window=window,
                               n_blocks=n_blocks)
    n_items = -(-Sq // fa.WGMMA_BM) * B * Hq
    assert len(blocks) == min(n_blocks, n_items)
    got = sorted((b, h, q0) for blk in blocks for b, h, q0, _ in blk)
    assert got == sorted((b, h, q0) for b in range(B) for h in range(Hq)
                         for q0 in range(0, Sq, fa.WGMMA_BM))
    # items per block differ by at most one
    lens = [len(blk) for blk in blocks]
    assert max(lens) - min(lens) <= 1


def test_wgmma_schedule_order_and_balance_at_the_prefill_shape():
    """qwen2-7b's prefill on 132 SMs: the list's causal tiles run longest
    first, a KV head's 7 query heads are adjacent in it (so they share
    K/V tiles in L2), and every block gets the same number of key tiles."""
    B, S, Hq, G = 2, 4096, 28, 7
    blocks = fa.wgmma_schedule(B, S, S, Hq, causal=True, n_blocks=132)
    first_round = [blk[0] for blk in blocks]        # items 0 .. 131
    tiles = [t for _, _, _, t in first_round]
    assert tiles == sorted(tiles, reverse=True) and tiles[0] == S // 128
    assert [h // G for _, h, _, _ in first_round[:G]] == [0] * G
    for blk in blocks:           # round r's item is later in the list
        assert [t for *_, t in blk] == sorted((t for *_, t in blk),
                                             reverse=True)
    per_block = {sum(t for *_, t in blk) for blk in blocks}
    assert per_block == {S // 128 * (S // 128 + 1) // 2 * B * Hq // 132}


def test_launcher_refusals_that_need_no_card():
    """Head dims the named design is not built for (MLA's (192, 128) on
    "wgmma"; reduced MLA's (24, 16) on every design), a type the design
    does not take, and TMA's 16-byte alignment raise before any launch."""
    q = torch.zeros(1, 8, 4, 32, dtype=torch.bfloat16)
    k = torch.zeros(1, 8, 2, 32, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="not built for 'wgmma'"):
        fa._launch(q, k, k, causal=True, q_offset=0, window=0,
                   design="wgmma")
    q, k = torch.zeros(1, 8, 2, 192, dtype=torch.bfloat16), \
        torch.zeros(1, 8, 2, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="not built for 'wgmma'"):
        fa._launch(q, q, k, causal=True, q_offset=0, window=0,
                   design="wgmma")
    q, k = torch.zeros(1, 8, 2, 24), torch.zeros(1, 8, 2, 16)
    for dtype, design in ((torch.bfloat16, "mma_sync"),
                          (torch.float32, "f32")):
        with pytest.raises(ValueError, match=f"not built for '{design}'"):
            fa._launch(q.to(dtype), q.to(dtype), k.to(dtype), causal=True,
                       q_offset=0, window=0, design=design)
    q = torch.zeros(1, 8, 4, 32, dtype=torch.bfloat16)
    k = torch.zeros(1, 8, 2, 32, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="design"):
        fa._launch(q.float(), k.float(), k.float(), causal=True, q_offset=0,
                   window=0, design="mma_sync")
    flat = torch.zeros(1 + 8 * 4 * 128, dtype=torch.bfloat16)
    q = flat[1:].view(1, 8, 4, 128)           # 2 bytes off the allocation
    k = torch.zeros(1, 8, 2, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        fa._launch(q, k, k, causal=True, q_offset=0, window=0,
                   design="wgmma")


def test_wgmma_products_on_cpu_are_the_plain_products():
    rng = np.random.default_rng(5)
    q, k, v = (torch.tensor(rng.normal(0, 1, (128, 64)).astype(np.float32))
               .bfloat16() for _ in range(3))
    s, o = fa.wgmma_products(q, k, v)
    assert torch.equal(s, q.float() @ k.float().T)
    assert torch.equal(o, s.bfloat16().float() @ v.float())
    with pytest.raises(ValueError):
        fa.wgmma_products(q[:64], k[:64], v[:64])


# ---------------------------------------------------------------------------
# the card: the kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def dev():
    """Decided inside the test, never at collection time, so every
    worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def assert_kernel_close(got, want, q, k, v, **kw):
    """The bars of this file: float32 1e-5; bfloat16 the rounding bound
    of ``bf16_error_bound``, never past BF16_ATOL + BF16_RTOL * |plain|."""
    assert got.dtype == want.dtype and got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    if got.dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=F32_TOL, rtol=F32_TOL)
        return
    err = (got.float() - want.float()).abs()
    bar = torch.minimum(bf16_error_bound(q, k, v, got, want, **kw),
                        BF16_ATOL + BF16_RTOL * want.float().abs())
    worst = int((err - bar).argmax())
    assert bool((err <= bar).all()), (
        f"max |err| {float(err.max()):.3g}; at element {worst} |err| "
        f"{float(err.flatten()[worst]):.3g} > bar "
        f"{float(bar.flatten()[worst]):.3g}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", MODEL_CASES + [FULL_CASE], ids=_case_id)
def test_kernel_matches_plain(dev, case, dtype):
    _, _, _, _, _, _, _, causal, qo, w = case
    q, k, v = (torch.tensor(a).to(dev, dtype) for a in _inputs(case))
    build.reset_launches()
    got = flash_attention(q, k, v, causal=causal, q_offset=qo, window=w)
    torch.cuda.synchronize()
    assert build.LAUNCHES["flash_attention"] == 1
    kw = dict(causal=causal, q_offset=qo, window=w)
    assert_kernel_close(got, flash_attention_plain(q, k, v, **kw), q, k, v,
                        **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("d,dv", HEAD_DIMS)
def test_kernel_every_built_head_dim(dev, d, dv):
    case = (2, 130, 130, 4, 2, d, dv, True, 0, 0)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.tensor(a).to(dev, dtype) for a in _inputs(case))
        got = flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        assert_kernel_close(got, flash_attention_plain(q, k, v, causal=True),
                            q, k, v, causal=True)


@pytest.mark.cuda
def test_kernel_raises_on_what_it_does_not_take(dev):
    q = torch.zeros(1, 8, 4, 48, device=dev)
    with pytest.raises(ValueError, match="not built"):
        flash_attention(q, q, q, causal=True)
    q = torch.zeros(1, 8, 16, 4, device=dev).transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q, q, q, causal=True)


@pytest.mark.cuda
@pytest.mark.parametrize("case", WGMMA_CASES, ids=_case_id)
def test_wgmma_kernel_matches_plain(dev, case):
    _, _, _, _, _, _, _, causal, qo, w = case
    q, k, v = (torch.tensor(a).to(dev, torch.bfloat16)
               for a in _inputs(case, seed=11))
    build.reset_launches()
    got = flash_attention(q, k, v, causal=causal, q_offset=qo, window=w)
    torch.cuda.synchronize()
    assert build.LAUNCHES["flash_attention"] == 1
    assert build.LAUNCHES["flash_attention:wgmma"] == 1
    kw = dict(causal=causal, q_offset=qo, window=w)
    assert_kernel_close(got, flash_attention_plain(q, k, v, **kw), q, k, v,
                        **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("d,dv", WGMMA_HEAD_DIMS)
def test_wgmma_products_match_plain(dev, d, dv):
    """The kernel's two products alone (its TMA boxes, swizzle,
    descriptors and fragments): S = q k^T against float32 (the bf16
    products are exact in f32; only the order of the sums differs), and
    P V with P = bf16(S) against float32 on the kernel's own S."""
    rng = np.random.default_rng(d)
    q, k = (torch.tensor(rng.normal(0, 1, (128, d)).astype(np.float32))
            .to(dev, torch.bfloat16) for _ in range(2))
    v = torch.tensor(rng.normal(0, 1, (128, dv)).astype(np.float32)).to(
        dev, torch.bfloat16)
    s, o = fa.wgmma_products(q, k, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(s, q.float() @ k.float().T, atol=1e-4,
                               rtol=1e-5)
    torch.testing.assert_close(o, s.bfloat16().float() @ v.float(),
                               atol=1e-3, rtol=1e-5)


@pytest.mark.cuda
def test_prefill_launches_run_the_wgmma_design(dev):
    """A 28-layer model with qwen2-7b's heads (28 / 4 of 128; narrow
    elsewhere): each of serve_prefill's 28 flash_attention launches runs
    the wgmma design."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as tfm
    from repro_torch.models.lm import serve_prefill
    cfg = dataclasses.replace(get_config("qwen2-7b"), d_model=256,
                              d_ff=512, vocab_size=512)
    assert (cfg.num_layers, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim) == (28, 28, 4, 128)
    params = tfm.init_params(torch.Generator(device=dev).manual_seed(0),
                             cfg, device=dev)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 256)), device=dev)
    build.reset_launches()
    logits, _ = serve_prefill(params, cfg, {"tokens": toks})
    torch.cuda.synchronize()
    assert bool(torch.isfinite(logits).all())
    assert build.LAUNCHES["flash_attention"] == 28
    assert build.LAUNCHES["flash_attention:wgmma"] == 28


@pytest.mark.cuda
@pytest.mark.parametrize("d,dv", [p for p in HEAD_DIMS
                                  if p not in WGMMA_HEAD_DIMS])
def test_small_head_dims_run_the_mma_sync_design(dev, d, dv):
    case = (1, 70, 70, 4, 2, d, dv, True, 0, 0)
    q, k, v = (torch.tensor(a).to(dev, torch.bfloat16) for a in _inputs(case))
    build.reset_launches()
    got = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert build.LAUNCHES["flash_attention:mma_sync"] == 1
    assert build.LAUNCHES["flash_attention:wgmma"] == 0
    assert_kernel_close(got, flash_attention_plain(q, k, v, causal=True),
                        q, k, v, causal=True)


@pytest.mark.cuda
def test_mma_sync_design_at_the_prefill_head_dim(dev):
    """The earlier design stays callable at d = 128 for timing, and right."""
    case = (1, 300, 300, 14, 2, 128, 128, True, 0, 0)
    q, k, v = (torch.tensor(a).to(dev, torch.bfloat16) for a in _inputs(case))
    build.reset_launches()
    got = fa._launch(q, k, v, causal=True, q_offset=0, window=0,
                     design="mma_sync")
    torch.cuda.synchronize()
    assert build.LAUNCHES["flash_attention:mma_sync"] == 1
    assert_kernel_close(got, flash_attention_plain(q, k, v, causal=True),
                        q, k, v, causal=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", MLA_CASES, ids=_case_id)
def test_mla_head_dims_on_the_card(dev, case, dtype):
    """deepseek-v3's MLA prefill shape (d, dv) = (192, 128): bf16 on
    "mma_sync" within the rounding bound, float32 on "f32" within 1e-5."""
    _, _, _, _, _, _, _, causal, qo, w = case
    q, k, v = (torch.tensor(a).to(dev, dtype)
               for a in _inputs(case, seed=17))
    build.reset_launches()
    got = flash_attention(q, k, v, causal=causal, q_offset=qo, window=w)
    torch.cuda.synchronize()
    design = "f32" if dtype == torch.float32 else "mma_sync"
    assert build.LAUNCHES[f"flash_attention:{design}"] == 1
    kw = dict(causal=causal, q_offset=qo, window=w)
    assert_kernel_close(got, flash_attention_plain(q, k, v, **kw), q, k, v,
                        **kw)
