"""``python -m repro_torch`` — the trec_eval-compatible CLI (see cli)."""

import sys

from repro_torch.cli import main

sys.exit(main())
