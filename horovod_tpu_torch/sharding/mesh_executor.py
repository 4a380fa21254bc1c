"""The eager plane's executor over a mesh's ``dp`` axis (port of
``horovod_tpu/sharding/mesh_executor.py``).

``ops/nccl_executor.py``'s :class:`Executor` runs the plane's collectives
over the world.  ``MeshExecutor`` runs the same collectives (it inherits
them unchanged) and speaks the ``parallel.mesh`` axis vocabulary: its
:attr:`mesh` is the flat mesh over the plane's ranks along ``dp``, so
eager collectives and the model-parallel modules
(``parallel/{tensor_parallel,pipeline,moe}.py``) agree on one topology,
and :meth:`named_sharding` places model tensors on it.  Select it with
``HVD_TPU_EXECUTOR=mesh`` (read in ``hvd.init()``; a value other than
``psum`` or ``mesh`` raises there).
"""

from horovod_tpu_torch.ops.nccl_executor import Executor
from horovod_tpu_torch.parallel.mesh import MeshAxes, make_mesh
from horovod_tpu_torch.parallel.tensor_parallel import NamedSharding


class MeshExecutor(Executor):
    """:class:`Executor` whose :attr:`mesh` is ``{axis_name: size}`` over
    the plane's ranks (``dp`` by default: gradients sum over ``dp``, as
    every model of ``horovod_tpu_torch.parallel`` expects)."""

    def __init__(self, group, rank, size, device, axis_name=MeshAxes.DP):
        super().__init__(group, rank, size, device)
        self.axis_name = axis_name
        self.mesh = make_mesh({axis_name: size}, devices=range(size))

    def named_sharding(self, *spec):
        """A :class:`~horovod_tpu_torch.parallel.tensor_parallel.NamedSharding`
        on this executor's mesh; ``spec`` holds axis names (or None), one
        per dimension, as ``PartitionSpec``'s.  ``tensor_parallel.shard_tensor``
        and ``shard_params`` take it."""
        return NamedSharding(self.mesh, tuple(spec))
