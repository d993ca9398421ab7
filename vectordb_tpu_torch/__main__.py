"""Entry point: python -m vectordb_tpu_torch <command>."""

import sys

from .cli import main

sys.exit(main())
