"""`python -m sketchtpu_torch` == sketchtpu's CLI on the port's engines."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
