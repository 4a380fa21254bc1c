"""Flash attention: CUDA kernels for the card, plain PyTorch for CPU
tensors.

Port of ``horovod_tpu/ops/pallas/flash_attention.py``.  The kernels are in
``csrc/flash_attention.cu`` (in bf16 on ``wgmma`` with TMA tile
pipelines, the forward a persistent kernel with one block an SM; in fp32
with scalar FMAs); the note there gives the TPU kernels they replace,
their bound on the H100 and their design.

- ``flash_attention_fwd``, ``flash_attention_bwd_dq`` and
  ``flash_attention_bwd_dkv`` are the three kernel wrappers.  A CUDA
  tensor launches the kernel (or raises); a CPU tensor takes the plain
  version beside it, which repeats the kernel's arithmetic: scores in
  fp32, scaled after the product, the top-left causal mask ``q_pos >=
  k_pos`` filled with -1e30, and P and dS rounded to the input dtype
  before their products.
- ``flash_attention(q, k, v, *, causal, scale, return_lse)`` is the
  differentiable entry point over ``[B, T, H, D]``.

Layouts: q ``[B, T_q, H, D]``, k and v ``[B, T_kv, H, D]``, read through
their strides (D contiguous); out, dq, dk, dv contiguous ``[B, T, H, D]``;
lse and delta fp32 ``[B, H, T_q]``.  fp32 and bf16; any D from 1 up
(``MAX_D``: 65535 blocks of 256 columns), B*H up to 2^31 - 1, T up to
65535 tiles of 64 rows.  bf16 at D a multiple of 16 up to 128 runs the
``wgmma`` kernels, which read through TMA and so need 16-byte aligned
rows; every other shape runs the generic kernels, which need only D
contiguous, and above D = 256 split the output's columns over blocks of
256 (each recomputes the scores over all of D).
"""

import ctypes
import math

import torch

from horovod_tpu_torch.ops.cuda import _build

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_NEG_INF = -1e30
SPLIT_D = 256  # csrc/flash_attention.cu kMaxD: above it, the column split
MAX_D = 65535 * SPLIT_D  # grid.z blocks of SPLIT_D columns
MAX_BH = 2 ** 31 - 1  # grid.x
MAX_T = 65535 * 64  # grid.y tiles of 64 rows
DTYPES = (torch.float32, torch.bfloat16)


# ------------------------------------------------------------ plain versions
def _scores(q, k, causal, scale):
    """fp32 scores ``[B, H, T_q, T_kv]``, masked entries -1e30."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        tq, tk = s.shape[-2:]
        keep = (torch.arange(tq, device=s.device)[:, None]
                >= torch.arange(tk, device=s.device)[None, :])
        s = s.masked_fill(~keep, _NEG_INF)
    return s


def flash_attention_fwd_plain(q, k, v, causal, scale):
    s = _scores(q, k, causal, scale)
    m = s.amax(-1, keepdim=True)
    p = torch.where(m > _NEG_INF / 2, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    l_safe = torch.where(l > 0, l, 1.0)
    o = torch.einsum("bhqk,bkhd->bhqd", p.to(q.dtype).float(), v.float())
    out = (o / l_safe).transpose(1, 2).to(q.dtype)
    return out, (m + torch.log(l_safe)).squeeze(-1)


def _probs_and_dscores(q, k, v, dout, lse, delta, causal, scale):
    """Recomputed ``p = exp(s - lse)`` (zero on fully masked rows, whose
    lse is -1e30) and ``ds = p * (dp - delta) * scale``."""
    s = _scores(q, k, causal, scale)
    lse4 = lse[..., None]
    p = torch.where(lse4 > _NEG_INF / 2, torch.exp(s - lse4), 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.float(), v.float())
    return p, p * (dp - delta[..., None]) * scale


def flash_attention_bwd_dq_plain(q, k, v, dout, lse, delta, causal, scale):
    _, ds = _probs_and_dscores(q, k, v, dout, lse, delta, causal, scale)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(q.dtype).float(), k.float())
    return dq.to(q.dtype)


def flash_attention_bwd_dkv_plain(q, k, v, dout, lse, delta, causal, scale):
    p, ds = _probs_and_dscores(q, k, v, dout, lse, delta, causal, scale)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(q.dtype).float(), dout.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


# ----------------------------------------------------------- kernel wrappers
def _wgmma_route(dtype, d):
    """bf16 at D a multiple of 16 up to 128 runs the ``wgmma`` kernels
    (``csrc/flash_attention.cu`` ``sm90k_route``); the rest the generic
    ones."""
    return dtype == torch.bfloat16 and d % 16 == 0 and d <= 128


def _kernel_strides_ok(x):
    """D contiguous; on the ``wgmma`` route also every row starting on a
    16-byte boundary (TMA tensor maps take only strides that are multiples
    of 16 bytes)."""
    if x.stride(-1) != 1:
        return False
    if not _wgmma_route(x.dtype, x.shape[-1]):
        return True
    align = 16 // x.element_size()
    return (x.data_ptr() % 16 == 0
            and all(s % align == 0 for s in x.stride()[:-1]))


def _check(what, q, k, v, dout=None):
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")
    named = [("q", q), ("k", k), ("v", v)]
    if dout is not None:
        named.append(("dout", dout))
    for name, t in named:
        if t.dtype not in DTYPES:
            raise TypeError(f"{what}: unsupported dtype {t.dtype} for "
                            f"{name}; expected one of {list(DTYPES)}")
        if t.dim() != 4:
            raise ValueError(f"{what}: {name} must be [B, T, H, D], got "
                             f"shape {tuple(t.shape)}")
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{what}: {name} is {t.dtype} on {t.device}, "
                             f"q is {q.dtype} on {q.device}")
        if not _kernel_strides_ok(t):
            raise ValueError(
                f"{what}: {name} strides {t.stride()} are not taken (D must "
                f"be contiguous, and rows 16-byte aligned for bf16 at D a "
                f"multiple of 16 up to 128)")
    b, tq, h, d = q.shape
    tkv = k.shape[1]
    if (k.shape != (b, tkv, h, d) or v.shape != k.shape
            or (dout is not None and dout.shape != q.shape)):
        raise ValueError(
            f"{what}: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)}"
            + ("" if dout is None else f", dout {tuple(dout.shape)}")
            + " do not match")
    if not 1 <= d <= MAX_D:
        raise ValueError(f"{what}: head dim {d} outside [1, {MAX_D}], the "
                         f"widest the kernels take")
    if min(b, h, tq, tkv) < 1 or b * h > MAX_BH or max(tq, tkv) > MAX_T:
        raise ValueError(f"{what}: B*H = {b * h}, T_q = {tq}, T_kv = {tkv}: "
                         f"each must be at least 1, B*H at most {MAX_BH} and "
                         f"T at most {MAX_T}")
    return b, tq, tkv, h, d


def _check_rows(t, b, h, tq, device, what):
    if (t.shape != (b, h, tq) or t.dtype != torch.float32
            or t.device != device or not t.is_contiguous()):
        raise ValueError(f"{what}: expected a contiguous fp32 [{b}, {h}, "
                         f"{tq}] tensor on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def _strides(*tensors):
    flat = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(flat))(*flat)


def flash_attention_fwd(q, k, v, causal, scale):
    """-> (out [B, T_q, H, D] in q's dtype, lse [B, H, T_q] fp32)."""
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal, scale)
    b, tq, tkv, h, d = _check("flash_attention_fwd", q, k, v)
    out = torch.empty(b, tq, h, d, device=q.device, dtype=q.dtype)
    lse = torch.empty(b, h, tq, device=q.device, dtype=torch.float32)
    fn = _build.function("hvd_flash_fwd", _P, _P, _P, _P, _P, _I, _I, _I,
                         _I, _I, _P, _F, _I, _I, _P)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr(), b, h, tq, tkv, d, _strides(q, k, v),
             float(scale), int(causal), _build.dtype_code(q, "flash"),
             _build.stream_ptr(q))
    _build.check(err, "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0


def flash_attention_fwd_plan(b, h, tq, d):
    """The bf16 ``wgmma`` forward kernel's launch plan on the current card
    for q of shape ``[b, tq, h, d]`` (d a multiple of 16 up to 128):
    ``{"grid": blocks, "k_stages": ..., "v_stages": ...}`` (one block an
    SM, or one a 128-row work tile)."""
    if not _wgmma_route(torch.bfloat16, d):
        raise ValueError(f"flash_attention_fwd_plan: head dim {d} does not "
                         f"run the wgmma forward")
    fn = _build.function("hvd_flash_fwd_plan", _I, _I, _I, _I, _P, _P, _P)
    vals = [ctypes.c_int() for _ in range(3)]
    _build.check(fn(b, h, tq, d, *map(ctypes.byref, vals)),
                 "flash_attention_fwd_plan")
    return dict(zip(("grid", "k_stages", "v_stages"),
                    (v.value for v in vals)))


def _check_bwd(what, q, k, v, dout, lse, delta):
    b, tq, tkv, h, d = _check(what, q, k, v, dout)
    _check_rows(lse, b, h, tq, q.device, f"{what} lse")
    _check_rows(delta, b, h, tq, q.device, f"{what} delta")
    return b, tq, tkv, h, d


def flash_attention_bwd_dq(q, k, v, dout, lse, delta, causal, scale):
    """-> dq [B, T_q, H, D] in q's dtype."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_plain(q, k, v, dout, lse, delta,
                                            causal, scale)
    b, tq, tkv, h, d = _check_bwd("flash_attention_bwd_dq", q, k, v, dout,
                                  lse, delta)
    dq = torch.empty(b, tq, h, d, device=q.device, dtype=q.dtype)
    fn = _build.function("hvd_flash_bwd_dq", _P, _P, _P, _P, _P, _P, _P, _I,
                         _I, _I, _I, _I, _P, _F, _I, _I, _P)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, h, tq, tkv,
             d, _strides(q, k, v, dout), float(scale), int(causal),
             _build.dtype_code(q, "flash"), _build.stream_ptr(q))
    _build.check(err, "flash_attention_bwd_dq")
    flash_attention_bwd_dq.launches += 1
    return dq


flash_attention_bwd_dq.launches = 0


def flash_attention_bwd_dkv(q, k, v, dout, lse, delta, causal, scale):
    """-> (dk, dv) [B, T_kv, H, D] in k's dtype."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_plain(q, k, v, dout, lse, delta,
                                             causal, scale)
    b, tq, tkv, h, d = _check_bwd("flash_attention_bwd_dkv", q, k, v, dout,
                                  lse, delta)
    dk = torch.empty(b, tkv, h, d, device=q.device, dtype=q.dtype)
    dv = torch.empty_like(dk)
    fn = _build.function("hvd_flash_bwd_dkv", _P, _P, _P, _P, _P, _P, _P,
                         _P, _I, _I, _I, _I, _I, _P, _F, _I, _I, _P)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             b, h, tq, tkv, d, _strides(q, k, v, dout), float(scale),
             int(causal), _build.dtype_code(q, "flash"),
             _build.stream_ptr(q))
    _build.check(err, "flash_attention_bwd_dkv")
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_bwd_dkv.launches = 0


# --------------------------------------------------------------- autograd
def _forward(ctx, q, k, v, causal, scale):
    out, lse = flash_attention_fwd(q, k, v, causal, scale)
    # residuals as the reference's (q, k, v, out, lse)
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.causal, ctx.scale = causal, scale
    return out, lse


def _backward(ctx, g, g_lse=None):
    q, k, v, out, lse = ctx.saved_tensors
    # delta = rowsum(dO * O) in fp32 from the saved output; an lse
    # cotangent folds in as delta -= g_lse (reference :345-351)
    delta = (g.float() * out.float()).sum(-1).transpose(1, 2)
    if g_lse is not None:
        delta = delta - g_lse.float()
    delta = delta.contiguous()
    g = _kernel_layout(g)
    dq = flash_attention_bwd_dq(q, k, v, g, lse, delta, ctx.causal,
                                ctx.scale)
    dk, dv = flash_attention_bwd_dkv(q, k, v, g, lse, delta, ctx.causal,
                                     ctx.scale)
    return dq, dk, dv, None, None


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        return _forward(ctx, q, k, v, causal, scale)[0]

    @staticmethod
    def backward(ctx, g):
        return _backward(ctx, g)


class _FlashLse(torch.autograd.Function):
    """Also returns the logsumexp: the streaming-softmax state that ring
    attention combines per block."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        return _forward(ctx, q, k, v, causal, scale)

    @staticmethod
    def backward(ctx, g, g_lse):
        return _backward(ctx, g, g_lse)


def _kernel_layout(x):
    """``x`` itself where the kernels take its strides, else a contiguous
    copy."""
    if x.device.type != "cuda" or _kernel_strides_ok(x):
        return x
    return x.clone(memory_format=torch.contiguous_format)


def flash_attention(q, k, v, *, causal=False, scale=None, return_lse=False):
    """Flash multi-head attention, ``[B, T_q, H, D]`` (q) and ``[B, T_kv, H,
    D]`` (k, v) -> ``[B, T_q, H, D]``; differentiable.  ``scale`` defaults
    to ``1/sqrt(D)``; ``causal`` masks top-left (``q_pos >= k_pos``).  With
    ``return_lse`` also returns the differentiable logsumexp ``[B, H,
    T_q]`` (fp32)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    q, k, v = (_kernel_layout(x) for x in (q, k, v))
    fn = _FlashLse if return_lse else _Flash
    return fn.apply(q, k, v, bool(causal), float(scale))
