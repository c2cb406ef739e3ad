"""Evaluation through the fused kernel (one device; multi-GPU comes later)."""

from repro_torch.distributed.sharded_evaluator import (ShardedEvaluator,
                                                       ShardedResult,
                                                       select_backend)

__all__ = ["ShardedEvaluator", "ShardedResult", "select_backend"]
