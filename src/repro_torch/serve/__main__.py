"""``python -m repro_torch.serve`` — run the evaluation service front-end."""

import sys

from repro_torch.serve.frontend import main

if __name__ == "__main__":
    sys.exit(main())
