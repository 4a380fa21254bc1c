"""The port's CUDA kernels against their plain PyTorch versions, on the
card, at shapes the main path does not reach: odd row counts, widths that
are no multiple of a 16-byte vector (the kernels' scalar path), fp32 and
fp16, d = 8192 and the widest row the LayerNorm takes, logits at scale
200; flash attention at head dims 16 to 128 (48, 80 and 112 padded in the
bf16 kernels), 24, 40, 192, 256 and odd ones (the generic kernels),
257, 320, 384 and 512 (the column split over blocks of 256), B*H = 65536, ragged lengths at the kernels' tile edges, and
cross-attention lengths.  This file imports no JAX, so it also runs on a
machine without it:

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py

Without a card every test skips.  Tolerances: fp32 outputs 1e-5 (sums
taken in another order), half-precision outputs one rounding (1e-2);
dlogits entry by entry at their own scale (``_close_dlogits``); flash
attention as stated at ``test_flash_kernels_match_plain``."""

import numpy as np
import pytest
import torch

from horovod_tpu_torch.ops.cuda import flash_attention as fa
from horovod_tpu_torch.ops.cuda import layer_norm as ln
from horovod_tpu_torch.ops.cuda import softmax_xent as sx

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2, torch.float16: 1e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _close(got, want, tol):
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("n,d,dtype", [
    (7, 1001, torch.float32),      # scalar path
    (33, 1024, torch.bfloat16),
    (5, 8192, torch.float32),      # backward: wide path, 8 warps a row
    (600, 256, torch.float16),     # more rows than backward blocks
    (3, 12, torch.bfloat16),       # d below one block of threads
    (9, 8192, torch.bfloat16),     # backward: 8 warps share a row
    (7, 1001, torch.bfloat16),     # scalar path, one warp a row
    (1, 1024, torch.bfloat16),     # one row
    (1003, 1024, torch.bfloat16),  # no multiple of the rows of a block
    (3, ln.MAX_D, torch.float32),  # the widest row: 15 warps
])
def test_layer_norm_kernels_match_plain(dev, n, d, dtype):
    rng = np.random.RandomState(n + d)
    x = torch.from_numpy(rng.randn(n, d).astype(np.float32)).to(dev, dtype)
    g = torch.from_numpy(rng.randn(d).astype(np.float32)).to(dev)
    b = torch.from_numpy(rng.randn(d).astype(np.float32)).to(dev)
    dy = torch.from_numpy(rng.randn(n, d).astype(np.float32)).to(dev, dtype)
    tol = TOL[dtype]

    out, mean, rstd = ln.layer_norm_fwd(x, g, b, 1e-6, True)
    p_out, p_mean, p_rstd = ln.layer_norm_fwd_plain(x, g, b, 1e-6)
    _close(out, p_out, tol)
    _close(mean, p_mean, 1e-5)
    _close(rstd, p_rstd, 1e-4)
    out2, none, _ = ln.layer_norm_fwd(x, g, b, 1e-6, False)
    assert none is None
    torch.testing.assert_close(out2, out, rtol=0, atol=0)

    dx, dg, db = ln.layer_norm_bwd(x, g, mean, rstd, dy)
    p_dx, p_dg, p_db = ln.layer_norm_bwd_plain(x, g, mean, rstd, dy)
    _close(dx, p_dx, tol)
    scale = float(p_dg.abs().max()) + float(p_db.abs().max())
    _close(dg / scale, p_dg / scale, 1e-4)
    _close(db / scale, p_db / scale, 1e-4)


@pytest.mark.parametrize("n,d,dtype", [
    (4096, 512, torch.float32),
    (16384, 1024, torch.bfloat16),  # the main path's shape
])
def test_layer_norm_backward_is_deterministic(dev, n, d, dtype):
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(n, d).astype(np.float32)).to(dev, dtype)
    g = torch.ones(d, device=dev)
    dy = torch.from_numpy(rng.randn(n, d).astype(np.float32)).to(dev, dtype)
    _, mean, rstd = ln.layer_norm_fwd(x, g, g, 1e-6, True)
    first = ln.layer_norm_bwd(x, g, mean, rstd, dy)
    for _ in range(3):
        again = ln.layer_norm_bwd(x, g, mean, rstd, dy)
        for a, b in zip(first, again):
            assert torch.equal(a, b)


def test_layer_norm_forward_at_main_shape(dev):
    """The forward at the main path's shape, with and without statistics,
    against its plain version."""
    rng = np.random.RandomState(11)
    n, d = 16384, 1024
    x = torch.from_numpy(rng.randn(n, d).astype(np.float32)).to(
        dev, torch.bfloat16)
    g = torch.from_numpy(1 + 0.1 * rng.randn(d).astype(np.float32)).to(dev)
    b = torch.from_numpy(0.1 * rng.randn(d).astype(np.float32)).to(dev)
    out, mean, rstd = ln.layer_norm_fwd(x, g, b, 1e-6, True)
    p_out, p_mean, p_rstd = ln.layer_norm_fwd_plain(x, g, b, 1e-6)
    _close(out, p_out, TOL[torch.bfloat16])
    _close(mean, p_mean, 1e-5)
    _close(rstd, p_rstd, 1e-4)
    out2, _, _ = ln.layer_norm_fwd(x, g, b, 1e-6, False)
    assert torch.equal(out2, out)


@pytest.mark.parametrize("n,d,dtype", [
    (16384, 1024, torch.bfloat16),  # the main path's: one warp a row
    (3000, 1001, torch.bfloat16),   # scalar path
    (700, 8192, torch.bfloat16),    # 8 warps share a row
    (40, 12000, torch.bfloat16),    # wide rows: one group a block
])
def test_layer_norm_forward_rows_are_independent(dev, n, d, dtype):
    """out, mean and rstd of x[i:j] are bitwise those rows of the result
    for the whole x: the ranges start and end inside a block's rows and
    cross the rows that one pass of the grid covers, so a prefetch that
    mixed rows, or a row whose sums depended on where it fell, would
    show."""
    rng = np.random.RandomState(n)
    x = torch.from_numpy(rng.randn(n, d).astype(np.float32)).to(dev, dtype)
    g = torch.from_numpy(rng.randn(d).astype(np.float32)).to(dev)
    b = torch.from_numpy(rng.randn(d).astype(np.float32)).to(dev)
    full = ln.layer_norm_fwd(x, g, b, 1e-6, True)
    for i, j in ((0, 1), (3, 5), (5, 37), (n // 3, n // 3 + 2113),
                 (n - 9, n)):
        j = min(j, n)
        part = ln.layer_norm_fwd(x[i:j], g, b, 1e-6, True)
        for got, want in zip(part, full):
            assert torch.equal(got, want[i:j]), (i, j)


@pytest.mark.parametrize("n,v,dtype,scale", [
    (5, 1001, torch.float32, 3.0),     # scalar path
    (16, 32768, torch.bfloat16, 1.0),
    (16, 512, torch.float32, 200.0),
    (9, 768, torch.float16, 3.0),
])
def test_softmax_xent_kernels_match_plain(dev, n, v, dtype, scale):
    rng = np.random.RandomState(n + v)
    x = torch.from_numpy((rng.randn(n, v) * scale).astype(np.float32)).to(
        dev, dtype)
    lab = torch.from_numpy(rng.randint(0, v, n).astype(np.int32)).to(dev)
    dloss = torch.from_numpy(rng.rand(n).astype(np.float32)).to(dev)

    loss, lse = sx.softmax_xent_fwd(x, lab, True)
    p_loss, p_lse = sx.softmax_xent_fwd_plain(x, lab)
    _close(loss, p_loss, 1e-5 * scale)
    _close(lse, p_lse, 1e-5 * scale)
    dx = sx.softmax_xent_bwd(x, lab, lse, dloss)
    _close_dlogits(dx, sx.softmax_xent_bwd_plain(x, lab, lse, dloss), lab,
                   dloss)


def _close_dlogits(got, want, labels, dloss):
    """Every entry at its own scale (most are far below the label
    entry's): one rounding to the dtype (one ulp of it, relative; 1e-5
    for fp32), plus 1/128 of the dtype's smallest normal number, where
    subnormal results keep few bits; the label entry exp(x - lse) - 1 also
    a few fp32 ulps of 1, times its row's dloss, lost to cancellation."""
    torch.cuda.synchronize()
    fi = torch.finfo(want.dtype)
    rtol = 1e-5 if want.dtype == torch.float32 else fi.eps
    tol = rtol * want.float().abs() + fi.tiny / 128
    rows = torch.arange(want.shape[0], device=want.device)
    tol[rows, labels.long()] += 2 ** -20 * dloss.float()
    err = (got.float() - want.float()).abs()
    assert (err <= tol).all(), float((err / tol).max())


def test_autograd_functions_launch_the_kernels(dev):
    from horovod_tpu_torch.ops import cuda as kernels

    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(2, 3, 64).astype(np.float32)).to(dev)
    g = torch.ones(64, device=dev, requires_grad=True)
    b = torch.zeros(64, device=dev, requires_grad=True)
    xr = x.clone().requires_grad_(True)
    kernels.reset_launch_counts()
    y = ln.layer_norm(xr, g, b)
    loss = sx.softmax_xent(y, torch.zeros(2, 3, dtype=torch.long,
                                          device=dev)).mean()
    loss.backward()
    counts = kernels.launch_counts()
    assert counts == dict(dict.fromkeys(counts, 0), **dict.fromkeys(
        ["layer_norm_fwd", "layer_norm_bwd", "softmax_xent_fwd",
         "softmax_xent_bwd"], 1))

    xc = x.cpu().requires_grad_(True)
    gc = torch.ones(64, requires_grad=True)
    bc = torch.zeros(64, requires_grad=True)
    yc = ln.layer_norm(xc, gc, bc)
    sx.softmax_xent(yc, torch.zeros(2, 3, dtype=torch.long)).mean().backward()
    _close(xr.grad.cpu(), xc.grad, 1e-5)
    _close(g.grad.cpu(), gc.grad, 1e-5)


def test_wrappers_check_their_inputs(dev):
    x = torch.randn(4, 8, device=dev)
    with pytest.raises(ValueError):
        ln.layer_norm_fwd(x, torch.ones(8, device=dev, dtype=torch.float16),
                          torch.zeros(8, device=dev))
    with pytest.raises(ValueError):
        ln.layer_norm_fwd(x.t(), torch.ones(4, device=dev),
                          torch.zeros(4, device=dev))
    with pytest.raises(TypeError):
        ln.layer_norm_fwd(x.double(), torch.ones(8, device=dev),
                          torch.zeros(8, device=dev))
    with pytest.raises(ValueError):
        sx.softmax_xent_fwd(x, torch.zeros(4, dtype=torch.long, device=dev))


def _qkvdo(dev, dtype, b, tq, tkv, h, d, seed=0):
    """q, k, v as strided views of one [B, T, 3, H, D] tensor (as the
    model's qkv.unbind hands them over) when T_q == T_kv; dO contiguous."""
    rng = np.random.RandomState(seed)
    mk = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32)).to(
        dev, dtype)
    if tq == tkv:
        q, k, v = mk(b, tq, 3, h, d).unbind(dim=2)
    else:
        q, k, v = mk(b, tq, h, d), mk(b, tkv, h, d), mk(b, tkv, h, d)
    return q, k, v, mk(b, tq, h, d)


def _close_rows(got, want, tol, what, noise=0.0):
    """Each (b, t, h) row of D entries within ``tol`` times that row's
    largest entry of the plain version, never above ``tol`` times the
    tensor's largest: out and dq of query i fall as 1/sqrt(i), dk and dv
    of key j likewise, so one limit for the tensor would leave the small
    rows unchecked.  Plus 2^-18 of the tensor's largest entry: a query
    that sees one key has dp = delta, so its dq is fp32 cancellation
    noise in both.  ``noise`` is an absolute allowance for a tensor that
    is all such noise (dq and dk when every query sees one key)."""
    torch.cuda.synchronize()
    w = want.float()
    top = float(w.abs().max())
    limit = (tol * w.abs().amax(-1) + 2 ** -18 * top).clamp(
        max=tol * top) + noise
    worst = float(((got.float() - w).abs().amax(-1) / limit).max())
    assert worst <= 1, (what, worst)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,tq,tkv,h,d,causal", [
    (2, 96, 96, 3, 16, True),      # ragged edge tile
    (2, 128, 128, 2, 32, True),
    (1, 2048, 2048, 2, 128, True),  # the main path's T and D
    (2, 128, 128, 2, 128, False),
    (2, 64, 128, 2, 32, False),    # cross-attention
    (2, 64, 128, 2, 32, True),     # top-left causal, T_q < T_kv
    (1, 130, 70, 2, 16, True),     # T_q > T_kv, both ragged
    # the bf16 kernels' tile edges (128 queries or keys a block, 64 or 128
    # a tile) and head dims padded to their 64- or 128-column instances
    (1, 1, 1, 2, 64, True),
    (2, 127, 127, 2, 128, True),
    (2, 128, 128, 2, 48, True),
    (1, 129, 129, 2, 80, True),
    (1, 255, 255, 2, 112, True),
    (2, 128, 320, 2, 64, True),
    (2, 128, 320, 2, 64, False),
    (2, 320, 128, 2, 128, True),
    (2, 320, 128, 2, 128, False),
    # dq: the second warpgroup of a 128-row block wholly past T_q, and a
    # warpgroup that skips whole key tiles above its diagonal
    (2, 64, 192, 2, 128, True),
    (2, 64, 192, 2, 128, False),
    (2, 65, 192, 2, 64, True),
    (2, 65, 192, 2, 64, False),
    (1, 192, 320, 2, 128, True),
    # head dims the wgmma kernels do not take (the generic kernels, in
    # bf16 too): not a multiple of 16, above 128 (the 256-column instance
    # with its 32-row inner tile), odd (element-wise loads and stores)
    (2, 96, 96, 2, 24, True),
    (2, 96, 96, 2, 24, False),
    (2, 130, 70, 2, 40, True),
    (2, 64, 128, 2, 40, False),
    (2, 129, 129, 2, 192, True),
    (2, 64, 160, 2, 192, False),
    (2, 129, 129, 2, 256, True),
    (1, 100, 100, 2, 256, False),
    (1, 33, 33, 3, 7, True),
    (1, 17, 40, 2, 1, False),
    # above 256 the column split: two blocks of output columns (257, odd:
    # element-wise stores past a block's edge; 320; 384) or two whole ones
    # (512), each summing the scores over all of D; ragged T
    (2, 129, 129, 2, 257, True),
    (1, 96, 160, 2, 257, False),
    (2, 130, 70, 2, 320, True),
    (1, 100, 100, 2, 320, False),
    (1, 129, 129, 2, 384, True),
    (2, 64, 130, 2, 384, False),
    (1, 160, 96, 2, 512, True),
    (2, 100, 100, 2, 512, False),
])
def test_flash_kernels_match_plain(dev, dtype, b, tq, tkv, h, d, causal):
    """Tolerances: fp32 outputs within 1e-5 of each row's largest entry of
    the plain version (sums taken in another order, full fp32 products);
    bf16 within 2e-2 (P and dS are rounded to bf16 at other points of the
    online softmax, outputs to bf16); see ``_close_rows``.  lse 1e-4
    absolute in both (only the order of the fp32 sums differs)."""
    q, k, v, do = _qkvdo(dev, dtype, b, tq, tkv, h, d, seed=tq + d)
    scale = 1 / d ** 0.5
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    out, lse = fa.flash_attention_fwd(q, k, v, causal, scale)
    p_out, p_lse = fa.flash_attention_fwd_plain(q, k, v, causal, scale)
    assert out.is_contiguous() and out.shape == q.shape
    _close_rows(out, p_out, tol, "out")
    _close(lse, p_lse, 1e-4)

    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    # with one key (T_kv = 1) every p is 1 and dS = dp - delta is zero
    # but for fp32 rounding in both versions: allow that noise, 2^-16 of
    # the terms that cancel (|dO| |v| summed over D), times the scale and
    # the largest |q| or |k| that dS multiplies
    noise = 0.0
    if tkv == 1:
        noise = 2 ** -16 * scale * float(
            (do.float().abs() * v.float().abs()).sum(-1).max()) * float(
                torch.stack([q.float().abs().max(), k.float().abs().max()])
                .max())
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal, scale)
    _close_rows(dq, fa.flash_attention_bwd_dq_plain(
        q, k, v, do, lse, delta, causal, scale), tol, "dq", noise)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal,
                                        scale)
    p_dk, p_dv = fa.flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta,
                                                  causal, scale)
    _close_rows(dk, p_dk, tol, "dk", noise)
    _close_rows(dv, p_dv, tol, "dv")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 24])
def test_flash_kernels_take_65536_heads(dev, dtype, d):
    """B*H = 65536, above the 65535 blocks of a grid's y: both routes put
    B*H on grid.x (bf16 at d = 16 the wgmma kernels, the rest the generic
    ones).  Tolerances as at ``test_flash_kernels_match_plain``."""
    q, k, v, do = _qkvdo(dev, dtype, 256, 16, 16, 256, d, seed=d)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    out, lse = fa.flash_attention_fwd(q, k, v, True, 0.25)
    _close_rows(out, fa.flash_attention_fwd_plain(q, k, v, True, 0.25)[0],
                tol, "out")
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, True, 0.25)
    _close_rows(dq, fa.flash_attention_bwd_dq_plain(
        q, k, v, do, lse, delta, True, 0.25), tol, "dq")
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, True, 0.25)
    p_dk, p_dv = fa.flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta,
                                                  True, 0.25)
    _close_rows(dk, p_dk, tol, "dk")
    _close_rows(dv, p_dv, tol, "dv")


@pytest.mark.parametrize("b,t,h,d,causal,scale", [
    # more work tiles (9 x 36 = 324) than twice the persistent grid, the
    # last tile of every (b, h) ragged
    (4, 1100, 9, 128, True, None),
    (4, 1100, 9, 128, False, None),
    (4, 1100, 9, 64, True, None),
    # fewer work tiles (2 x 3 = 6) than SMs
    (1, 256, 3, 128, True, None),
    (3, 100, 2, 64, False, None),
    # a negative scale (the row max comes from the smallest score) and a
    # zero one (every kept key weighs the same; masked keys none)
    (2, 300, 2, 128, True, -0.1),
    (2, 300, 2, 128, True, 0.0),
])
def test_flash_forward_persistent_matches_plain(dev, b, t, h, d, causal,
                                                scale):
    """The persistent bf16 forward, whose blocks walk many tiles or only
    one, against its plain version (tolerances as at
    ``test_flash_kernels_match_plain``)."""
    q, k, v, _ = _qkvdo(dev, torch.bfloat16, b, t, t, h, d, seed=t + h)
    scale = 1 / d ** 0.5 if scale is None else scale
    out, lse = fa.flash_attention_fwd(q, k, v, causal, scale)
    p_out, p_lse = fa.flash_attention_fwd_plain(q, k, v, causal, scale)
    _close_rows(out, p_out, 2e-2, "out")
    _close(lse, p_lse, 1e-4)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_forward_slice_alone_is_bitwise_batched(dev, causal):
    """One (b, h) computed alone (one block a tile) is bitwise the same
    (b, h) computed inside the batch (each block walking several tiles of
    other heads): no m, l, O or barrier phase leaks from one tile of a
    block to the next."""
    b, t, h, d = 4, 1100, 9, 128
    q, k, v, _ = _qkvdo(dev, torch.bfloat16, b, t, t, h, d, seed=3)
    out, lse = fa.flash_attention_fwd(q, k, v, causal, 0.125)
    for bi, hi in ((0, 0), (1, 4), (3, 8)):
        one = lambda x: x[bi:bi + 1, :, hi:hi + 1]
        o1, l1 = fa.flash_attention_fwd(one(q), one(k), one(v), causal,
                                        0.125)
        assert torch.equal(o1, one(out)), (bi, hi)
        assert torch.equal(l1[0, 0], lse[bi, hi]), (bi, hi)


def test_flash_row_check_fails_a_dropped_tile(dev):
    """``_close_rows`` at the main path's T and D fails kernels that skip
    the last 64-row tile of keys (forward, dq) or of queries (dk/dv),
    made by running the real kernels on inputs cut by that tile: with
    top-left causal masking, T_kv = T - 64 drops exactly the last key
    tile.  One limit for the tensor (2e-2 of its largest entry) lets the
    forward's and dv's faults through at this shape, since the rows they
    spoil are the smallest; the row check fails all four."""
    t, cut, scale = 2048, 2048 - 64, 128 ** -0.5
    q, k, v, do = _qkvdo(dev, torch.bfloat16, 1, t, t, 2, 128, seed=5)
    out, lse = fa.flash_attention_fwd(q, k, v, True, scale)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    p_out, _ = fa.flash_attention_fwd_plain(q, k, v, True, scale)
    p_dq = fa.flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, True,
                                           scale)
    p_dk, p_dv = fa.flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta,
                                                  True, scale)
    kc, vc = k[:, :cut], v[:, :cut]
    bad_out, _ = fa.flash_attention_fwd(q, kc, vc, True, scale)
    bad_dq = fa.flash_attention_bwd_dq(q, kc, vc, do, lse, delta, True, scale)
    bad_dk, bad_dv = fa.flash_attention_bwd_dkv(
        q[:, :cut], k, v, do[:, :cut], lse[..., :cut].contiguous(),
        delta[..., :cut].contiguous(), True, scale)
    for got, want, what in ((bad_out, p_out, "out"), (bad_dq, p_dq, "dq"),
                            (bad_dk, p_dk, "dk"), (bad_dv, p_dv, "dv")):
        with pytest.raises(AssertionError):
            _close_rows(got, want, 2e-2, what)


@pytest.mark.parametrize("b,t,h", [(2, 512, 4), (1, 2048, 8)])
def test_flash_backward_is_deterministic(dev, b, t, h):
    """Bitwise equal over runs; at T = 512 each 128-key dk/dv block walks
    up to eight 64-query tiles through its pipeline, at T = 2048 (the main
    path's) each 128-row dq block up to 32 key tiles through its own."""
    q, k, v, do = _qkvdo(dev, torch.bfloat16, b, t, t, h, 128, seed=9)
    out, lse = fa.flash_attention_fwd(q, k, v, True, 0.125)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    first = (fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, True, 0.125),
             *fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, True,
                                         0.125))
    for _ in range(3):
        again = (fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, True,
                                           0.125),
                 *fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, True,
                                             0.125))
        for a, b in zip(first, again):
            assert torch.equal(a, b)


@pytest.mark.parametrize("return_lse", [False, True])
def test_flash_autograd_launches_each_kernel_once(dev, return_lse):
    from horovod_tpu_torch.ops import cuda as kernels

    q, k, v, do = _qkvdo(torch.device("cpu"), torch.float32, 2, 80, 80, 2,
                         32, seed=4)
    leaves = {}
    for where in ("cpu", "cuda"):
        qkv = [x.detach().to(where, copy=True).requires_grad_(True)
               for x in (q, k, v)]
        kernels.reset_launch_counts()
        res = fa.flash_attention(*qkv, causal=True, return_lse=return_lse)
        out, lse = res if return_lse else (res, None)
        loss = (out * do.to(where)).sum()
        if return_lse:
            loss = loss + lse.sin().sum()
        loss.backward()
        counts = kernels.launch_counts()
        want = 1 if where == "cuda" else 0
        assert [counts[n] for n in ("flash_attention_fwd",
                                    "flash_attention_bwd_dq",
                                    "flash_attention_bwd_dkv")] == [want] * 3
        leaves[where] = [out.detach()] + [x.grad for x in qkv]
    for got, want in zip(leaves["cuda"], leaves["cpu"]):
        _close(got.cpu(), want, 1e-5)


def test_flash_wrappers_check_their_inputs(dev):
    q = torch.zeros(1, 8, 2, 32, device=dev)
    with pytest.raises(TypeError):
        fa.flash_attention_fwd(q.half(), q.half(), q.half(), True, 1.0)
    x = torch.zeros(1, 8, 2, 0, device=dev)   # no head dim
    with pytest.raises(ValueError, match="head dim .* outside"):
        fa.flash_attention_fwd(x, x, x, True, 1.0)
    for wide_d in (257, 512):    # taken: the column split above 256
        x = torch.zeros(1, 8, 2, wide_d, device=dev)
        out, lse = fa.flash_attention_fwd(x, x, x, True, 1.0)
        assert out.shape == x.shape and lse.shape == (1, 2, 8)
    with pytest.raises(ValueError, match="wgmma"):  # no wgmma plan at 192
        fa.flash_attention_fwd_plan(1, 2, 8, 192)
    with pytest.raises(ValueError):      # k on another device
        fa.flash_attention_fwd(q, q.cpu(), q, True, 1.0)
    with pytest.raises(ValueError):      # v's shape differs from k's
        fa.flash_attention_fwd(q, q, q[:, :4], True, 1.0)
    with pytest.raises(ValueError, match="strides"):   # D not contiguous
        x = torch.zeros(1, 8, 32, 2, device=dev).transpose(2, 3)
        fa.flash_attention_fwd(x, x, x, True, 1.0)
    lse = torch.zeros(1, 2, 8, device=dev)
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_bwd_dq(q, q, q, q, lse[:, :1], lse, True, 1.0)
    with pytest.raises(ValueError):      # dout's shape differs from q's
        fa.flash_attention_bwd_dkv(q, q, q, q[:, :4], lse, lse, True, 1.0)
    # the public function copies what the kernels do not take
    x = torch.randn(1, 8, 32, 2, device=dev).transpose(2, 3)
    torch.testing.assert_close(
        fa.flash_attention(x, x, x, causal=True),
        fa.flash_attention(x.contiguous(), x.contiguous(), x.contiguous(),
                           causal=True))


@pytest.mark.parametrize("b,t,h,d,causal", [
    (2, 4096, 8, 128, True),     # a ring's diagonal block on the card
    (2, 4096, 8, 128, False),    # a block behind it, and zigzag's C x C
    (1, 128, 2, 16, False),      # zigzag's C x C on the CPU tests' flash
    (1, 130, 2, 320, True),      # a ring block above D = 256: the split
])
def test_flash_lse_cotangent_matches_plain(dev, b, t, h, d, causal):
    """``flash_attention(..., return_lse=True)`` with a nonzero lse
    cotangent, as each hop of ring and zigzag attention differentiates it:
    the backward folds ``g_lse`` into delta (``delta = rowsum(dO * O) -
    g_lse``).  dq, dk and dv against the plain versions given that delta,
    tolerances as at ``test_flash_kernels_match_plain`` (bf16: 2e-2 of
    each row's largest entry); out 2e-2, lse 1e-4."""
    q, k, v, do = _qkvdo(dev, torch.bfloat16, b, t, t, h, d, seed=t + d)
    g_lse = torch.from_numpy(np.random.RandomState(d).randn(b, h, t).astype(
        np.float32)).to(dev)
    scale = d ** -0.5
    leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    out, lse = fa.flash_attention(*leaves, causal=causal, return_lse=True)
    ((out.float() * do.float()).sum() + (lse * g_lse).sum()).backward()
    p_out, p_lse = fa.flash_attention_fwd_plain(q, k, v, causal, scale)
    _close_rows(out, p_out, 2e-2, "out")
    _close(lse, p_lse, 1e-4)
    delta = ((do.float() * out.detach().float()).sum(-1).transpose(1, 2)
             - g_lse).contiguous()
    lse = lse.detach()
    p_dq = fa.flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, causal,
                                           scale)
    p_dk, p_dv = fa.flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta,
                                                  causal, scale)
    for got, want, what in zip([x.grad for x in leaves], (p_dq, p_dk, p_dv),
                               ("dq", "dk", "dv")):
        _close_rows(got, want, 2e-2, what)


def test_ulysses_default_attention_launches_the_flash_kernels(dev,
                                                              tmp_path):
    """``ulysses_attention`` with ``attn_fn=None`` on card tensors runs
    the flash kernels (one launch of each for forward and backward at
    one rank, where the all-to-alls move nothing), and its out, dq, dk
    and dv match the plain flash versions within 2e-2 of each row's
    largest entry (bf16, as above)."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import cuda as kernels
    from horovod_tpu_torch.parallel import ulysses_attention

    q, k, v, do = _qkvdo(dev, torch.bfloat16, 2, 256, 256, 4, 64, seed=9)
    scale = 64 ** -0.5
    hvd.init(store_path=str(tmp_path / "store"))
    try:
        leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
        kernels.reset_launch_counts()
        out = ulysses_attention(*leaves, causal=True)
        (out.float() * do.float()).sum().backward()
        counts = kernels.launch_counts()
    finally:
        hvd.shutdown()
    assert [counts[n] for n in ("flash_attention_fwd",
                                "flash_attention_bwd_dq",
                                "flash_attention_bwd_dkv")] == [1, 1, 1]
    p_out, lse = fa.flash_attention_fwd_plain(q, k, v, True, scale)
    delta = (do.float() * out.detach().float()).sum(-1).transpose(1, 2) \
        .contiguous()
    p_dq = fa.flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, True,
                                           scale)
    p_dk, p_dv = fa.flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta,
                                                  True, scale)
    for got, want, what in zip([out] + [x.grad for x in leaves],
                               (p_out, p_dq, p_dk, p_dv),
                               ("out", "dq", "dk", "dv")):
        _close_rows(got, want, 2e-2, what)
