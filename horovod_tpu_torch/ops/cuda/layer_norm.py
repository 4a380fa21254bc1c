"""Fused LayerNorm over the last axis: CUDA kernels for the card, plain
PyTorch for CPU tensors.

Port of ``horovod_tpu/ops/pallas/layer_norm.py``.  The kernels are in
``csrc/layer_norm.cu``; the note there gives the TPU kernels they
replace, their bound on the H100 and their design.

- ``layer_norm_fwd`` / ``layer_norm_bwd`` are the two kernel wrappers.
  A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
  plain version beside it, which repeats the kernel's arithmetic.
- ``layer_norm`` is the differentiable entry point (an
  ``autograd.Function`` whose backward is the backward kernel).  The
  statistics-free forward runs when no input needs a gradient, as the TPU
  kernel's primal path does.
- ``layer_norm_reference`` is the plain textbook LayerNorm, the oracle.

Statistics and the affine parameters are fp32; the output has the input's
dtype.
"""

import ctypes
import functools

import torch

from horovod_tpu_torch.ops.cuda import _build

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# Blocks of the backward: at least _BWD_ROWS rows each (one a warp), at
# most _BWD_BLOCKS (about one wave on an H100, where the kernel's registers
# allow one 8-warp block an SM).  A function of n alone, so that
# dgamma/dbeta are summed in the same order on every card.
_BWD_ROWS, _BWD_BLOCKS = 8, 128
# Blocks of the forward: at most _FWD_BLOCKS_PER_SM for each SM of the card.
# The kernel is built for 2 resident blocks of 8 warps an SM (128
# registers a thread); a grid of 4 an SM lets a second set of blocks take
# the rows that the first leaves, which timed faster than 2 on an H100 at
# [16384, 1024] bf16.  The kernel launches fewer when n leaves some block
# without a row (8 rows a block at a time at one warp a row).  Every row's
# arithmetic is the same whatever the count, so the count may follow the
# card.
_FWD_BLOCKS_PER_SM = 4
# largest d the kernels take (csrc/layer_norm.cu kMaxD)
MAX_D = (232448 // 4 - 32) // 4


def layer_norm_reference(x, gamma, beta, eps=1e-6):
    """Plain LayerNorm (fp32 statistics), the oracle for tests."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    out = (x32 - mean) * torch.rsqrt(var + eps) * gamma + beta
    return out.to(x.dtype)


# ------------------------------------------------------------ plain versions
def layer_norm_fwd_plain(x2, gamma, beta, eps, with_stats=True):
    x = x2.float()
    mean = x.mean(-1)
    centred = x - mean[:, None]
    rstd = torch.rsqrt(centred.square().mean(-1) + eps)
    out = (centred * rstd[:, None] * gamma.float() + beta.float())
    out = out.to(x2.dtype)
    return (out, mean, rstd) if with_stats else (out, None, None)


def layer_norm_bwd_plain(x2, gamma, mean, rstd, dy):
    x, dy32 = x2.float(), dy.float()
    xhat = (x - mean[:, None]) * rstd[:, None]
    dyg = dy32 * gamma.float()
    m1 = dyg.mean(-1, keepdim=True)
    m2 = (dyg * xhat).mean(-1, keepdim=True)
    dx = rstd[:, None] * (dyg - m1 - xhat * m2)
    return dx.to(x2.dtype), (dy32 * xhat).sum(0), dy32.sum(0)


# ----------------------------------------------------------- kernel wrappers
def _check_rows(x2, what):
    if x2.dim() != 2 or not x2.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous [rows, d] tensor, "
                         f"got shape {tuple(x2.shape)}")


def _check_vec(t, d, device, what, dtype=torch.float32):
    if (t.shape != (d,) or t.dtype != dtype or t.device != device
            or not t.is_contiguous()):
        raise ValueError(
            f"{what}: expected a contiguous {dtype} [{d}] tensor on "
            f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def _check_width(d, what):
    if d > MAX_D:
        raise ValueError(f"{what}: d={d} exceeds the kernel's limit of "
                         f"{MAX_D}")


@functools.cache
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def layer_norm_fwd(x2, gamma, beta, eps=1e-6, with_stats=True):
    """``x2`` [N, d] -> (out [N, d] in x2's dtype, mean [N], rstd [N]);
    mean/rstd are None unless ``with_stats``."""
    if x2.device.type == "cpu":
        return layer_norm_fwd_plain(x2, gamma, beta, eps, with_stats)
    if x2.device.type != "cuda":
        raise ValueError(f"layer_norm_fwd: unsupported device {x2.device}")
    _check_rows(x2, "layer_norm_fwd")
    n, d = x2.shape
    _check_vec(gamma, d, x2.device, "layer_norm_fwd gamma")
    _check_vec(beta, d, x2.device, "layer_norm_fwd beta")
    code = _build.dtype_code(x2, "layer_norm_fwd")
    _check_width(d, "layer_norm_fwd")
    out = torch.empty_like(x2)
    mean = rstd = None
    if with_stats:
        mean = torch.empty(n, device=x2.device, dtype=torch.float32)
        rstd = torch.empty_like(mean)
    if n == 0:
        return out, mean, rstd
    fn = _build.function("hvd_layer_norm_fwd", _P, _P, _P, _P, _P, _P, _I,
                         _I, _F, _I, _I, _P)
    max_blocks = _FWD_BLOCKS_PER_SM * _sm_count(x2.device.index)
    err = fn(x2.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
             out.data_ptr(), mean.data_ptr() if with_stats else None,
             rstd.data_ptr() if with_stats else None, n, d, float(eps),
             max_blocks, code, _build.stream_ptr(x2))
    _build.check(err, "layer_norm_fwd")
    layer_norm_fwd.launches += 1
    return out, mean, rstd


layer_norm_fwd.launches = 0


def layer_norm_bwd(x2, gamma, mean, rstd, dy):
    """-> (dx [N, d] in x2's dtype, dgamma [d] fp32, dbeta [d] fp32)."""
    if x2.device.type == "cpu":
        return layer_norm_bwd_plain(x2, gamma, mean, rstd, dy)
    if x2.device.type != "cuda":
        raise ValueError(f"layer_norm_bwd: unsupported device {x2.device}")
    _check_rows(x2, "layer_norm_bwd")
    _check_rows(dy, "layer_norm_bwd dy")
    n, d = x2.shape
    if dy.shape != x2.shape or dy.dtype != x2.dtype or dy.device != x2.device:
        raise ValueError(f"layer_norm_bwd: dy {dy.dtype} "
                         f"{tuple(dy.shape)} does not match x "
                         f"{x2.dtype} {tuple(x2.shape)}")
    _check_vec(gamma, d, x2.device, "layer_norm_bwd gamma")
    _check_vec(mean, n, x2.device, "layer_norm_bwd mean")
    _check_vec(rstd, n, x2.device, "layer_norm_bwd rstd")
    code = _build.dtype_code(x2, "layer_norm_bwd")
    _check_width(d, "layer_norm_bwd")
    dx = torch.empty_like(x2)
    dgamma = torch.empty(d, device=x2.device, dtype=torch.float32)
    dbeta = torch.empty_like(dgamma)
    if n == 0:
        return dx, dgamma.zero_(), dbeta.zero_()
    blocks = min(-(-n // _BWD_ROWS), _BWD_BLOCKS)
    partials = torch.empty(2, blocks, d, device=x2.device,
                           dtype=torch.float32)
    fn = _build.function("hvd_layer_norm_bwd", _P, _P, _P, _P, _P, _P, _P,
                         _P, _P, _I, _I, _I, _I, _P)
    err = fn(x2.data_ptr(), gamma.data_ptr(), mean.data_ptr(),
             rstd.data_ptr(), dy.data_ptr(), dx.data_ptr(),
             partials.data_ptr(), dgamma.data_ptr(), dbeta.data_ptr(), n, d,
             blocks, code, _build.stream_ptr(x2))
    _build.check(err, "layer_norm_bwd")
    layer_norm_bwd.launches += 1
    return dx, dgamma, dbeta


layer_norm_bwd.launches = 0


# --------------------------------------------------------------- autograd
class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        d = x.shape[-1]
        x2 = x.reshape(-1, d).contiguous()
        with_stats = any(ctx.needs_input_grad[:3])
        out, mean, rstd = layer_norm_fwd(x2, gamma, beta, eps, with_stats)
        if with_stats:
            ctx.save_for_backward(x2, gamma, mean, rstd)
        return out.view(x.shape)

    @staticmethod
    def backward(ctx, dout):
        x2, gamma, mean, rstd = ctx.saved_tensors
        dy = dout.reshape(x2.shape).contiguous()
        dx, dgamma, dbeta = layer_norm_bwd(x2, gamma, mean, rstd, dy)
        return (dx.view(dout.shape), dgamma.to(gamma.dtype),
                dbeta.to(gamma.dtype), None)


def layer_norm(x, gamma, beta, eps=1e-6):
    """Fused LayerNorm over the last axis of ``x`` (any leading shape)."""
    return _LayerNorm.apply(x, gamma, beta, eps)
