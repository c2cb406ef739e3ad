"""Post-compile analysis: roofline terms against an H100 model.

The JAX package's ``analysis/hlo.py`` (XLA HLO parsing) has no
counterpart: the port compiles no HLO.
"""
