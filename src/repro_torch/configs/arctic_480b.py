"""arctic-480b [hf:Snowflake/snowflake-arctic-base; hf]

35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000,
MoE 128 experts top-2 + parallel dense residual MLP.
"""

from __future__ import annotations

from repro_torch.configs.common import lm_shapes
from repro_torch.launch.api import ArchDef, register
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import TransformerConfig


def make_config(smoke: bool = False) -> TransformerConfig:
    if smoke:
        return TransformerConfig(
            name="arctic-smoke", n_layers=2, d_model=64, n_heads=8,
            n_kv_heads=2, d_ff=96, vocab_size=512, ffn="swiglu",
            moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=48,
                          dense_residual=True, capacity_factor=2.0),
            dtype="float32", remat=False)
    return TransformerConfig(
        name="arctic-480b", n_layers=35, d_model=7168, n_heads=56,
        n_kv_heads=8, d_ff=4864, vocab_size=32_000, ffn="swiglu",
        moe=MoEConfig(n_experts=128, top_k=2, d_ff_expert=4864,
                      dense_residual=True, capacity_factor=1.25),
        dtype="bfloat16", remat=True)


def _make_step(cfg, shape, device=None, mesh=None):
    from repro_torch.launch.steps import lm_step_bundle

    return lm_step_bundle(cfg, shape, device, opt_memory_efficient=True,
                          mesh=mesh, fsdp=True)


ARCH = register(ArchDef(
    name="arctic-480b",
    family="lm",
    shapes=lm_shapes(),
    make_config=make_config,
    make_step=_make_step,
    notes="Dense-residual MoE (arctic): MoE out + parallel dense MLP.",
))
