"""mind [arXiv:1904.08030; unverified]

embed_dim=64, 4 interest capsules, 3 routing iterations, multi-interest
retrieval.  Item vocabulary 1M; behavior history length 50.
"""

from __future__ import annotations

from repro_torch.configs.common import recsys_shapes
from repro_torch.launch.api import ArchDef, register
from repro_torch.models.embedding import TableConfig
from repro_torch.models.recsys import CTRConfig


def make_config(smoke: bool = False) -> CTRConfig:
    if smoke:
        return CTRConfig(
            name="mind-smoke",
            table=TableConfig(n_fields=1, vocab_per_field=1000, dim=16),
            n_interests=4, capsule_iters=3, hist_len=12)
    return CTRConfig(
        name="mind",
        table=TableConfig(n_fields=1, vocab_per_field=1_000_000, dim=64),
        n_interests=4, capsule_iters=3, hist_len=50)


def _make_step(cfg, shape, device=None, mesh=None):
    from repro_torch.launch.steps import recsys_step_bundle

    return recsys_step_bundle("mind", cfg, shape, device, mesh)


ARCH = register(ArchDef(
    name="mind",
    family="recsys",
    shapes=recsys_shapes(slate=1024),
    make_config=make_config,
    make_step=_make_step,
    notes="B2I dynamic routing (squash + logit updates, 3 iterations); "
          "retrieval scores = max over interests.",
))
