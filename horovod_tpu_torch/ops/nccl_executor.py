"""The eager plane's data plane: ``torch.distributed`` collectives on a
process group of its own (NCCL on the card, gloo on the CPU) and, on the
card, a CUDA stream of its own.

Port of ``horovod_tpu/ops/xla_executor.py``: ``allreduce_fused`` (:242),
``allgather`` (:432), ``reduce_scatter`` (:499), ``broadcast`` (:602) and
``alltoall`` (:714), with NCCL in place of the jitted ``psum`` /
``all_gather`` / ``psum_scatter`` programs, and ``adasum`` (:654).  The
arithmetic around the
collective is the reference's, in its order: prescale and the wire cast
before the sum; the cast back, the average and the postscale after it.
Integer tensors keep the sum exact and take all scaling once in float64,
cast back with truncation toward zero.  Block-scaled int8
(``_build_int8_allreduce``, :380) casts to fp32 and prescales, runs
:func:`~horovod_tpu_torch.common.compression.quantized_allreduce` on the
fused buffer, then averages and postscales in fp32 and casts back; its
reduce-scatter (:499) is that allreduce cut into the rank's rows.

Stream order on the card (the reference's ``ReadyEvent``,
``horovod/torch/ready_event.cc``): the plane's stream waits on the event
each input was submitted at, and the inputs and outputs are marked with
``record_stream`` for the stream that uses them, so that the caching
allocator does not hand their memory out early.  :meth:`Executor.run`
returns the event at which the outputs are complete.

Hierarchical allreduce and allgather (``HVD_HIERARCHICAL_ALLREDUCE``,
``HVD_HIERARCHICAL_ALLGATHER``, or the autotuner's candidate), when
``hvd.init`` set :attr:`Executor.hier`, the ``(cross, local)`` grid's
eager-plane groups (the world only: a process group's executor stays
flat, as the reference's sub-executors do).  The allreduce is
``xla_executor.py:314-331`` (``hier_body``): pad to a multiple of
``local * FUSION_ALIGN_ELEMS``, reduce-scatter over ``local``,
allreduce over ``cross``, allgather over ``local``; its int8 form
(:380-425) runs the quantized legs over ``local`` and the owned chunk
across ``cross`` in fp32.  The allgather (:465-473) gathers within
``local``, then across ``cross``: rank order is cross-major, as the
grid's.  Integers stay exact; floats differ from the flat path only in
the order of the sums.  Reduce-scatter, broadcast, alltoall and Adasum
are not switched by these knobs (Adasum has its own, below).

Adasum runs one tensor at a time: flat, an ``all_gather`` of the ranks'
contributions and the pairing tree on the stack; hierarchical, when
``hvd.init`` set :attr:`Executor.hierarchy` (``HVD_ADASUM_HIERARCHICAL``,
the world only: a process group's executor stays flat, as the
reference's sub-executors do), ``ops/adasum.py``'s local
reduce-scatter, cross VHDD and local all-gather.
"""

import collections
import contextlib
import math

import torch
import torch.distributed as dist
import torch.nn.functional as F

from horovod_tpu_torch.common.compression import (all_gather_into,
                                                  int8_chunk,
                                                  quantized_all_gather,
                                                  quantized_allreduce,
                                                  quantized_reduce_scatter,
                                                  reduce_scatter_into)
from horovod_tpu_torch.common.ops_enum import (INT8_BLOCK, ReduceOp,
                                               reduce_scatter_split_sizes)
from horovod_tpu_torch.ops.adasum import (adasum_reduce_hierarchical,
                                         adasum_reduce_stacked)

_WIRE = {"bf16": torch.bfloat16, "fp16": torch.float16}
# the hierarchical allreduce pads its buffer to a multiple of local *
# this many elements, so that the reduce-scatter's chunks are equal
# (xla_executor.py:51; the reference rounds its fusion buffer the same
# way, controller.cc:358-376)
FUSION_ALIGN_ELEMS = 64


def effective_compression(compression, dtype, size, total):
    """The wire format actually used for ``total`` elements of ``dtype``
    at ``size`` ranks: the exact dtype for integers, for a world of one
    rank, for casts that would change nothing and for int8 of fewer than
    one block (reference: ``XlaExecutor._effective_compression``).  It
    depends on nothing but its arguments, so every rank decides the
    same."""
    if compression not in _WIRE and compression != "int8":
        return "none"
    if not dtype.is_floating_point or size == 1 \
            or _WIRE.get(compression) == dtype \
            or (compression == "int8" and total < INT8_BLOCK):
        return "none"
    return compression


class Executor:
    def __init__(self, group, rank, size, device):
        self.group = group
        self.rank = rank
        self.size = size
        self.device = device
        self.stream = (torch.cuda.Stream(device) if device.type == "cuda"
                       else None)
        # reductions run, by the wire format they used
        self.wires = collections.Counter()
        # (local group, cross group) of hierarchical Adasum, or None
        self.hierarchy = None
        # (local group, cross group, local size) of the hierarchical
        # allreduce and allgather, or None; the switches are the
        # configured or tuned ones, and run flat without the groups
        self.hier = None
        self.hierarchical_allreduce = False
        self.hierarchical_allgather = False

    @contextlib.contextmanager
    def run(self, requests):
        """Run the body on the plane's stream after every request's input
        is ready; yields a list the body fills with ``(request, output
        tensors)``, and leaves in ``.done`` the event they are complete
        at (None on the CPU)."""
        box = _Run()
        if self.stream is None:
            yield box
            return
        waited = set()   # a grouped submission shares one event
        for req in requests:
            if req is not None:
                if id(req.ready) not in waited:
                    waited.add(id(req.ready))
                    self.stream.wait_event(req.ready)
                req.tensor.record_stream(self.stream)
        with torch.cuda.stream(self.stream):
            yield box
            box.done = torch.cuda.Event()
            box.done.record(self.stream)
        for req, outs in box.outputs:
            for out in outs:
                out.record_stream(req.stream)

    # ------------------------------------------------------------ allreduce
    def allreduce(self, tensors, shapes, dtype, op, prescale, postscale,
                  compression):
        """Fused allreduce of one rank's tensors (``None`` where this rank
        has joined: zeros).  -> the reduced tensors, new, in order."""
        sizes = [math.prod(s) for s in shapes]
        flat = torch.cat([
            (t.reshape(-1) if t is not None else
             torch.zeros(n, dtype=dtype, device=self.device))
            for t, n in zip(tensors, sizes)])
        flat = self._reduce(flat, op, prescale, postscale, compression)
        return [piece.view(shape) for piece, shape in
                zip(torch.split(flat, sizes), shapes)]

    def _reduce(self, flat, op, prescale, postscale, compression):
        """Sum a flat buffer of the plane's own over the ranks with the
        reference's scaling (``xla_executor.py:304-357``), in place where
        the dtype allows."""
        dtype = flat.dtype
        comp = self._wire(compression, dtype, flat.numel())
        hier = self.hier if self.hierarchical_allreduce else None
        if comp == "int8":
            return self._int8(flat, op, prescale, postscale, hier)
        wire = _WIRE.get(comp)
        if prescale != 1.0 and dtype.is_floating_point:
            flat.mul_(prescale)
        if wire is not None:
            flat = flat.to(wire)
        if hier is not None and flat.dtype != torch.bool:
            flat = self._hier_sum(flat, *hier)
        else:
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=self.group)
        return self._finish(flat, dtype, op, prescale, postscale)

    @staticmethod
    def _hier_sum(x, local, cross, n_local):
        """``hier_body`` of ``xla_executor.py:314-331``: the sum of ``x``
        over the world as a reduce-scatter within ``local``, an
        allreduce across ``cross`` and an allgather within ``local``."""
        total = x.numel()
        align = n_local * FUSION_ALIGN_ELEMS
        padded = -(-total // align) * align
        if padded != total:
            x = F.pad(x, (0, padded - total))
        chunk = torch.empty(padded // n_local, dtype=x.dtype,
                            device=x.device)
        reduce_scatter_into(chunk, x.contiguous(), op=dist.ReduceOp.SUM,
                            group=local)
        dist.all_reduce(chunk, op=dist.ReduceOp.SUM, group=cross)
        full = torch.empty(padded, dtype=x.dtype, device=x.device)
        all_gather_into(full, chunk, group=local)
        return full[:total]

    def _wire(self, compression, dtype, total):
        comp = effective_compression(compression, dtype, self.size, total)
        self.wires[comp] += 1
        return comp

    def _int8(self, flat, op, prescale, postscale, hier=None):
        """The reference's int8 allreduce (``xla_executor.py:380-420``):
        fp32, prescale, the quantized sum (hierarchical when ``hier``
        holds the groups: the quantized legs over ``local``, the owned
        chunk across ``cross`` in fp32), then the average and the
        postscale in fp32 and the cast back.  ``flat`` is not written."""
        x = flat.float()
        if prescale != 1.0:
            x = x * prescale
        if hier is None:
            x = quantized_allreduce(x, self.group)
        else:
            local, cross, n_local = hier
            total = x.numel()
            chunk = int8_chunk(total, n_local)
            x = F.pad(x, (0, n_local * chunk - total))
            red = quantized_reduce_scatter(x.view(n_local, chunk), local)
            dist.all_reduce(red, op=dist.ReduceOp.SUM, group=cross)
            x = quantized_all_gather(red, local)[:total]
        if op == ReduceOp.AVERAGE:
            x = x / self.size
        if postscale != 1.0:
            x = x * postscale
        return x.to(flat.dtype)

    def _finish(self, flat, dtype, op, prescale, postscale):
        """The cast back, the average and the postscale, on a reduced
        buffer of the plane's own."""
        flat = flat.to(dtype)
        if not dtype.is_floating_point:
            factor = prescale * postscale
            if op == ReduceOp.AVERAGE:
                factor /= self.size
            if factor != 1.0:
                flat = (flat.to(torch.float64) * factor).to(dtype)
            return flat
        if op == ReduceOp.AVERAGE:
            flat.div_(self.size)
        if postscale != 1.0:
            flat.mul_(postscale)
        return flat

    # --------------------------------------------------------------- adasum
    def adasum(self, tensor, shape, dtype):
        """Adasum of one tensor over the ranks (reference:
        ``XlaExecutor.adasum``, ``xla_executor.py:654-707``); ``None``
        where this rank has joined: zeros, which the zero-norm guard
        turns into plain addition.  -> the result, new, the same on
        every rank."""
        total = math.prod(shape)
        flat = (tensor.reshape(-1) if tensor is not None else
                torch.zeros(total, dtype=dtype, device=self.device))
        if self.hierarchy is not None:
            local, cross = self.hierarchy
            out = adasum_reduce_hierarchical(flat, local, cross,
                                             scalar_group=self.group)
        else:
            stacked = torch.empty(self.size, total, dtype=dtype,
                                  device=self.device)
            all_gather_into(stacked.view(-1), flat.contiguous(),
                            group=self.group)
            out = adasum_reduce_stacked(stacked)
        return out.view(shape)

    # ------------------------------------------------------------ allgather
    def allgather(self, tensor, dims0):
        """Concatenation of every rank's tensor along dim 0; rank ``r``'s
        has ``dims0[r]`` rows (reference: pad to the largest, gather,
        keep each rank's rows)."""
        rest = tuple(tensor.shape[1:])
        top = max(dims0)
        src = tensor.contiguous()
        if tensor.shape[0] != top:
            src = torch.zeros((top,) + rest, dtype=tensor.dtype,
                              device=self.device)
            src[:tensor.shape[0]] = tensor
        out = torch.empty((self.size * top,) + rest, dtype=tensor.dtype,
                          device=self.device)
        hier = self.hier if self.hierarchical_allgather else None
        if hier is None:
            all_gather_into(out, src, group=self.group)
        else:
            # within the fast group first, then the assembled blocks
            # across: cross-major rank order, the grid's
            local, cross, n_local = hier
            block = torch.empty((n_local * top,) + rest,
                                dtype=tensor.dtype, device=self.device)
            all_gather_into(block, src, group=local)
            all_gather_into(out, block, group=cross)
        if all(d == top for d in dims0):
            return out
        return torch.cat([out[r * top:r * top + d]
                          for r, d in enumerate(dims0)])

    # ------------------------------------------------------------ broadcast
    def broadcast(self, tensor, root):
        out = tensor.clone(memory_format=torch.contiguous_format)
        dist.broadcast(out, src=root, group=self.group)
        return out

    # ------------------------------------------------------------- alltoall
    def alltoall(self, tensor, splits):
        """``splits[src][dst]`` rows go from rank src to rank dst.  -> (the
        rows this rank receives, in source order; their counts)."""
        send = [int(n) for n in splits[self.rank]]
        recv = [int(row[self.rank]) for row in splits]
        out = torch.empty((sum(recv),) + tuple(tensor.shape[1:]),
                          dtype=tensor.dtype, device=self.device)
        dist.all_to_all_single(out, tensor.contiguous(), recv, send,
                               group=self.group)
        return out, recv

    # ------------------------------------------------------- reduce_scatter
    def reduce_scatter(self, tensor, op, prescale, postscale, compression):
        """The reduced tensor's rows ``reduce_scatter_split_sizes(dim0,
        size)[rank]``; each rank's block is padded to the largest, so that
        one ``reduce_scatter`` moves them all."""
        dtype = tensor.dtype
        rest = tuple(tensor.shape[1:])
        counts = reduce_scatter_split_sizes(tensor.shape[0], self.size)
        top = max(counts)
        comp = self._wire(compression, dtype, tensor.numel())
        if comp == "int8":
            # the reference's int8 reduce-scatter reduces the whole tensor
            # through both quantized legs, then keeps the rank's rows
            full = self._int8(tensor.reshape(-1), op, prescale,
                              postscale).view(tensor.shape)
            start = sum(counts[:self.rank])
            return full[start:start + counts[self.rank]].contiguous()
        wire = _WIRE.get(comp)
        x = tensor
        if prescale != 1.0 and dtype.is_floating_point:
            x = x * prescale
        if wire is not None:
            x = x.to(wire)
        if all(c == top for c in counts):
            src = x.contiguous()
        else:
            src = torch.zeros((self.size * top,) + rest, dtype=x.dtype,
                              device=self.device)
            offset = 0
            for r, c in enumerate(counts):
                src[r * top:r * top + c] = x[offset:offset + c]
                offset += c
        out = torch.empty((top,) + rest, dtype=x.dtype, device=self.device)
        reduce_scatter_into(out, src, op=dist.ReduceOp.SUM, group=self.group)
        out = self._finish(out[:counts[self.rank]], dtype, op, prescale,
                           postscale)
        return out.contiguous()


class _Run:
    __slots__ = ("outputs", "done")

    def __init__(self):
        self.outputs = []
        self.done = None
