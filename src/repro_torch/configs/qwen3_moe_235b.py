"""qwen3-moe-235b-a22b [hf:Qwen/Qwen3-30B-A3B family; hf]

94L d_model=4096 64H (GQA kv=4) d_ff=1536 vocab=151936, MoE 128 experts top-8.
"""

from __future__ import annotations

from repro_torch.configs.common import lm_shapes
from repro_torch.launch.api import ArchDef, register
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import TransformerConfig


def make_config(smoke: bool = False) -> TransformerConfig:
    if smoke:
        return TransformerConfig(
            name="qwen3-moe-smoke", n_layers=2, d_model=64, n_heads=8,
            n_kv_heads=2, d_ff=96, vocab_size=512, ffn="swiglu",
            moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=48,
                          capacity_factor=2.0),
            dtype="float32", remat=False)
    return TransformerConfig(
        name="qwen3-moe-235b-a22b", n_layers=94, d_model=4096, n_heads=64,
        n_kv_heads=4, d_ff=1536, vocab_size=151_936, ffn="swiglu",
        moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=1536,
                      capacity_factor=1.25),
        dtype="bfloat16", remat=True)


def _make_step(cfg, shape, device=None, mesh=None):
    from repro_torch.launch.steps import lm_step_bundle

    return lm_step_bundle(cfg, shape, device, opt_memory_efficient=True,
                          mesh=mesh, fsdp=True)


ARCH = register(ArchDef(
    name="qwen3-moe-235b-a22b",
    family="lm",
    shapes=lm_shapes(),
    make_config=make_config,
    make_step=_make_step,
    notes="MoE, 128 experts top-8; on a mesh expert-parallel over "
          "`model`, the expert FFN split over `data` (FSDP).",
))
