"""Synchronized BatchNorm over all ranks (port of
``horovod_tpu/torch/sync_batch_norm.py``; reference:
``horovod/torch/sync_batch_norm.py:35`` — allgather of per-rank
mean/var/count in forward, allreduced gradient statistics in backward),
on the eager plane's allgather and allreduce.  The affine parameters'
gradients stay this rank's own, as in the reference:
``DistributedOptimizer`` reduces them.
"""

import torch
import torch.nn.functional as F
from torch.autograd.function import Function

from horovod_tpu_torch import mpi_ops
from horovod_tpu_torch.common import basics


class SyncBatchNorm(torch.nn.modules.batchnorm._BatchNorm):
    """Applies synchronized batch normalization: statistics are computed over
    the global batch across every rank."""

    def __init__(self, num_features, eps=1e-5, momentum=0.1, affine=True,
                 track_running_stats=True):
        super().__init__(num_features, eps, momentum, affine,
                         track_running_stats)

    def _check_input_dim(self, input):
        if input.dim() < 2:
            raise ValueError(
                f"expected at least 2D input (got {input.dim()}D input)")

    def forward(self, input):
        self._check_input_dim(input)
        # exponential_average_factor semantics as in _BatchNorm:
        # momentum=None means a cumulative moving average driven by
        # num_batches_tracked — on EVERY training path, so single-rank
        # and distributed runs of the same module behave identically
        eaf = 0.0 if self.momentum is None else self.momentum
        if self.training and self.track_running_stats \
                and self.num_batches_tracked is not None:
            self.num_batches_tracked.add_(1)
            if self.momentum is None:
                eaf = 1.0 / float(self.num_batches_tracked)
        if not self.training or basics.size() == 1:
            return F.batch_norm(
                input, self.running_mean, self.running_var, self.weight,
                self.bias, self.training, eaf, self.eps)
        return _SyncBatchNormFn.apply(
            input, self.weight, self.bias, self.running_mean,
            self.running_var, self.eps, eaf)


class _SyncBatchNormFn(Function):
    @staticmethod
    def forward(ctx, input, weight, bias, running_mean, running_var, eps,
                momentum):
        reduce_dims = [0] + list(range(2, input.dim()))
        # statistics in float32 regardless of activation dtype
        inp32 = input.float()
        count = torch.tensor(
            [input.numel() // input.size(1)], dtype=torch.float32,
            device=input.device)
        mean = inp32.mean(dim=reduce_dims)
        # biased variance for normalization
        var = inp32.var(dim=reduce_dims, unbiased=False)

        # gather [count, mean..., var...] from every rank in one op
        packed = torch.cat([count, mean, var]).unsqueeze(0)
        gathered = mpi_ops.allgather(packed, name="sync_batch_norm.stats")
        counts = gathered[:, 0]
        means = gathered[:, 1:1 + mean.numel()]
        vars_ = gathered[:, 1 + mean.numel():]

        total = counts.sum()
        global_mean = (means * counts.unsqueeze(1)).sum(0) / total
        # law of total variance
        global_var = ((vars_ + (means - global_mean) ** 2)
                      * counts.unsqueeze(1)).sum(0) / total
        invstd = torch.rsqrt(global_var + eps)

        if running_mean is not None:
            unbiased = global_var * (total / (total - 1))
            running_mean.mul_(1 - momentum).add_(global_mean * momentum)
            running_var.mul_(1 - momentum).add_(unbiased * momentum)

        shape = [1, -1] + [1] * (input.dim() - 2)
        xhat = (inp32 - global_mean.reshape(shape)) * invstd.reshape(shape)
        if weight is not None:
            out = xhat * weight.float().reshape(shape) \
                + bias.float().reshape(shape)
        else:  # affine=False
            out = xhat

        ctx.save_for_backward(input, weight, global_mean, invstd, total)
        # activations keep the input dtype (bf16 stays bf16 distributed
        # and single-rank alike); stats stayed fp32 above
        return out.to(input.dtype)

    @staticmethod
    def backward(ctx, grad_output):
        input, weight, global_mean, invstd, total = ctx.saved_tensors
        reduce_dims = [0] + list(range(2, input.dim()))
        shape = [1, -1] + [1] * (input.dim() - 2)

        grad32 = grad_output.float()
        xmu = input.float() - global_mean.reshape(shape)
        sum_dy = grad32.sum(dim=reduce_dims)
        sum_dy_xmu = (grad32 * xmu).sum(dim=reduce_dims)

        # per-channel global sums across ranks
        packed = torch.cat([sum_dy, sum_dy_xmu]).unsqueeze(0)
        reduced = mpi_ops.allreduce(packed, op=mpi_ops.Sum,
                                    name="sync_batch_norm.grad_stats")[0]
        g_sum_dy = reduced[:sum_dy.numel()]
        g_sum_dy_xmu = reduced[sum_dy.numel():]

        scale = (weight.float() * invstd if weight is not None
                 else invstd).reshape(shape)
        grad_input = scale * (
            grad32 - (g_sum_dy.reshape(shape)
                      + xmu * (invstd ** 2).reshape(shape)
                      * g_sum_dy_xmu.reshape(shape)) / total)
        grad_input = grad_input.to(grad_output.dtype)

        if weight is not None:
            grad_weight = (sum_dy_xmu * invstd).to(weight.dtype)
            grad_bias = sum_dy.to(weight.dtype)
        else:
            grad_weight = None
            grad_bias = None
        return grad_input, grad_weight, grad_bias, None, None, None, None
