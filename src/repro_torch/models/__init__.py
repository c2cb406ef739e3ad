"""Recsys and GNN models in PyTorch (the port of ``repro.models``, recsys
and GNN parts).

Each model is an ``nn.Module`` built from its config on an explicit device
with a ``torch.Generator``; parameter names and layouts follow the JAX
package's pytrees, so :mod:`repro_torch.models.convert` carries JAX weights
across by copying.
"""
