"""Evaluation through the fused kernel (one device; multi-GPU comes later)."""

from repro_torch.distributed.sharded_evaluator import (ShardedEvaluator,
                                                       ShardedResult)

__all__ = ["ShardedEvaluator", "ShardedResult"]
