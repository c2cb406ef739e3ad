"""The paper's comparison baselines, implemented in this repo.

* ``pure_eval``      — pure-Python trec_eval measure engine (no numpy, torch
                       or jax).
                       Plays the role of trec_eval's C core in the
                       serialize-invoke-parse baseline, and is the independent
                       oracle for property tests.
* ``trec_eval_cli``  — file-based CLI around ``pure_eval`` (the subprocess
                       target of RQ1's serialize-invoke-parse workflow).
* ``native_ndcg``    — the fastest-native-Python NDCG of RQ2.
* ``workflow``       — serialize → invoke → parse driver (the thing the paper
                       shows is ≥17× slower).
"""
