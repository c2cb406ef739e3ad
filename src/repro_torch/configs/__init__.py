"""One module per ported architecture.

Each module registers a :class:`repro_torch.launch.api.ArchDef`; use
``repro_torch.launch.api.get_arch(name)`` / ``list_archs()``.
"""
