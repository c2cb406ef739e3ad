"""olmo-1b [arXiv:2402.00838; hf]

16L d_model=2048 16H (MHA kv=16) d_ff=8192 vocab=50304, non-parametric LN.
"""

from __future__ import annotations

from repro_torch.configs.common import lm_shapes
from repro_torch.launch.api import ArchDef, register
from repro_torch.models.transformer import TransformerConfig


def make_config(smoke: bool = False) -> TransformerConfig:
    if smoke:
        return TransformerConfig(
            name="olmo-smoke", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=4, d_ff=128, vocab_size=512, ffn="swiglu",
            norm="nonparam", tie_embeddings=True, dtype="float32",
            remat=False)
    return TransformerConfig(
        name="olmo-1b", n_layers=16, d_model=2048, n_heads=16,
        n_kv_heads=16, d_ff=8192, vocab_size=50_304, ffn="swiglu",
        norm="nonparam", tie_embeddings=True, dtype="bfloat16", remat=True)


def _make_step(cfg, shape, device=None, mesh=None):
    from repro_torch.launch.steps import lm_step_bundle

    return lm_step_bundle(cfg, shape, device, mesh=mesh)


ARCH = register(ArchDef(
    name="olmo-1b",
    family="lm",
    shapes=lm_shapes(),
    make_config=make_config,
    make_step=_make_step,
    notes="Non-parametric LayerNorm; tied embeddings.",
))
