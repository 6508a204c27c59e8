"""``python -m pydcop_tpu_torch`` entry point."""

import sys

from .dcop_cli import main

if __name__ == "__main__":
    sys.exit(main())
