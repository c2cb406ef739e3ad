"""sasrec [arXiv:1808.09781; paper]

embed_dim=50 n_blocks=2 n_heads=1 seq_len=50, self-attentive sequential rec.
Item vocabulary 1M (spec: tables 10^6–10^9 rows).
"""

from __future__ import annotations

from repro_torch.configs.common import recsys_shapes
from repro_torch.launch.api import ArchDef, register
from repro_torch.models.recsys import SASRecConfig


def make_config(smoke: bool = False) -> SASRecConfig:
    if smoke:
        return SASRecConfig(name="sasrec-smoke", n_items=1000, embed_dim=16,
                            n_blocks=2, n_heads=1, seq_len=10)
    return SASRecConfig(name="sasrec", n_items=1_000_000, embed_dim=50,
                        n_blocks=2, n_heads=1, seq_len=50)


def _make_step(cfg, shape, device=None, mesh=None):
    from repro_torch.launch.steps import recsys_step_bundle

    return recsys_step_bundle("sasrec", cfg, shape, device, mesh)


ARCH = register(ArchDef(
    name="sasrec",
    family="recsys",
    shapes=recsys_shapes(slate=1024),
    make_config=make_config,
    make_step=_make_step,
    notes="retrieval_cand scores the user state against 1M item embeddings "
          "(one matrix product + the top-k kernel); in-loop NDCG via the "
          "measure core.",
))
