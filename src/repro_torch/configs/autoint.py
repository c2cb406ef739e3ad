"""autoint [arXiv:1810.11921; paper]

39 sparse fields, embed_dim=16, 3 self-attention layers, 2 heads, d_attn=32.
"""

from __future__ import annotations

from repro_torch.configs.common import recsys_shapes
from repro_torch.launch.api import ArchDef, register
from repro_torch.models.embedding import TableConfig
from repro_torch.models.recsys import CTRConfig


def make_config(smoke: bool = False) -> CTRConfig:
    if smoke:
        return CTRConfig(
            name="autoint-smoke",
            table=TableConfig(n_fields=8, vocab_per_field=500, dim=8),
            n_attn_layers=2, n_attn_heads=2, d_attn=4)
    return CTRConfig(
        name="autoint",
        table=TableConfig(n_fields=39, vocab_per_field=1_000_000, dim=16),
        n_attn_layers=3, n_attn_heads=2, d_attn=32)


def _make_step(cfg, shape, device=None, mesh=None):
    from repro_torch.launch.steps import recsys_step_bundle

    return recsys_step_bundle("autoint", cfg, shape, device, mesh)


ARCH = register(ArchDef(
    name="autoint",
    family="recsys",
    shapes=recsys_shapes(),
    make_config=make_config,
    make_step=_make_step,
    notes="Multi-head self-attention over field embeddings.",
))
