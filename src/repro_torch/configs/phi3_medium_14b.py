"""phi3-medium-14b [arXiv:2404.14219; unverified]

40L d_model=5120 40H (GQA kv=10) d_ff=17920 vocab=100352, RoPE SwiGLU GQA.
"""

from __future__ import annotations

from repro_torch.configs.common import lm_shapes
from repro_torch.launch.api import ArchDef, register
from repro_torch.models.transformer import TransformerConfig


def make_config(smoke: bool = False) -> TransformerConfig:
    if smoke:
        return TransformerConfig(
            name="phi3-smoke", n_layers=2, d_model=64, n_heads=8,
            n_kv_heads=2, d_ff=192, vocab_size=512, ffn="swiglu",
            dtype="float32", remat=False)
    return TransformerConfig(
        name="phi3-medium-14b", n_layers=40, d_model=5120, n_heads=40,
        n_kv_heads=10, d_ff=17_920, vocab_size=100_352, ffn="swiglu",
        dtype="bfloat16", remat=True)


def _make_step(cfg, shape, device=None, mesh=None):
    from repro_torch.launch.steps import lm_step_bundle

    return lm_step_bundle(cfg, shape, device, mesh=mesh)


ARCH = register(ArchDef(
    name="phi3-medium-14b",
    family="lm",
    shapes=lm_shapes(),
    make_config=make_config,
    make_step=_make_step,
    notes="GQA with kv=10: on a 16-way `model` axis the KV heads are "
          "all-gathered and each rank reads the ones its query heads use.",
))
