"""xdeepfm [arXiv:1803.05170; paper]

39 sparse fields, embed_dim=10, CIN layers 200-200-200, MLP 400-400.
1M rows per field → 39M-row concatenated table.
First 3 fields carry multi-hot bags (the EmbeddingBag kernel's path).
"""

from __future__ import annotations

from repro_torch.configs.common import recsys_shapes
from repro_torch.launch.api import ArchDef, register
from repro_torch.models.embedding import TableConfig
from repro_torch.models.recsys import CTRConfig


def make_config(smoke: bool = False) -> CTRConfig:
    if smoke:
        return CTRConfig(
            name="xdeepfm-smoke",
            table=TableConfig(n_fields=8, vocab_per_field=500, dim=8),
            cin_layers=(16, 16), mlp_dims=(32, 32), n_multi_hot=2,
            multi_hot_len=4)
    return CTRConfig(
        name="xdeepfm",
        table=TableConfig(n_fields=39, vocab_per_field=1_000_000, dim=10),
        cin_layers=(200, 200, 200), mlp_dims=(400, 400), n_multi_hot=3,
        multi_hot_len=8)


def _make_step(cfg, shape, device=None, mesh=None):
    from repro_torch.launch.steps import recsys_step_bundle

    return recsys_step_bundle("xdeepfm", cfg, shape, device, mesh)


ARCH = register(ArchDef(
    name="xdeepfm",
    family="recsys",
    shapes=recsys_shapes(),
    make_config=make_config,
    make_step=_make_step,
    notes="CIN = outer product + one matrix product per layer; "
          "EmbeddingBag through the CUDA kernel on the card.",
))
