"""nemotron-4-15b [arXiv:2402.16819; unverified]

32L d_model=6144 48H (GQA kv=8) d_ff=24576 vocab=256000, squared-ReLU FFN.
"""

from __future__ import annotations

from repro_torch.configs.common import lm_shapes
from repro_torch.launch.api import ArchDef, register
from repro_torch.models.transformer import TransformerConfig


def make_config(smoke: bool = False) -> TransformerConfig:
    if smoke:
        return TransformerConfig(
            name="nemotron-smoke", n_layers=2, d_model=64, n_heads=8,
            n_kv_heads=2, d_ff=256, vocab_size=512, ffn="sq_relu",
            dtype="float32", remat=False)
    return TransformerConfig(
        name="nemotron-4-15b", n_layers=32, d_model=6144, n_heads=48,
        n_kv_heads=8, d_ff=24_576, vocab_size=256_000, ffn="sq_relu",
        dtype="bfloat16", remat=True)


def _make_step(cfg, shape, device=None, mesh=None):
    from repro_torch.launch.steps import lm_step_bundle

    return lm_step_bundle(cfg, shape, device, mesh=mesh)


ARCH = register(ArchDef(
    name="nemotron-4-15b",
    family="lm",
    shapes=lm_shapes(),
    make_config=make_config,
    make_step=_make_step,
    notes="Squared-ReLU FFN; 256k vocab.",
))
