"""Paper §4: query-expansion RL on a synthetic collection (PyTorch port).

Pyndri → ``data.synthetic_ir.ql_scores`` (Dirichlet QL ranking, in-process);
pytrec_eval → the port's ``core`` evaluation on the environment's device;
OpenAI Gym → a dependency-free environment with the same reset/step contract.
"""
