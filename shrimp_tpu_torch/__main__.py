"""`python -m shrimp_tpu_torch {index,map,merge,split-db,...} ...` (see
cli.py)."""
import sys

from .cli import main

sys.exit(main())
