"""Distribution layer: the sharded evaluator and the collective helpers.

:class:`ShardedEvaluator` splits the query axis over a 1-D mesh of devices
in one process (:func:`default_mesh`: every visible card).
:mod:`repro_torch.distributed.collectives` holds the SPMD helpers over a
``torch.distributed`` process group, the form a ``torchrun`` job uses;
:mod:`repro_torch.distributed.sharding` the sharding rules (JAX's
``PartitionSpec``s as axis-name tuples, their DTensor placements) and
:mod:`repro_torch.distributed.spmd` the rank-local collectives the sharded
models call over a ``DeviceMesh``.  The JAX package's ``shard_map`` shim
has no counterpart.
"""

from repro_torch.distributed.sharded_evaluator import (ShardedEvaluator,
                                                       ShardedResult,
                                                       default_mesh,
                                                       select_backend)

__all__ = ["ShardedEvaluator", "ShardedResult", "default_mesh",
           "select_backend"]
