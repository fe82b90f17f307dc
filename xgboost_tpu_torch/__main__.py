"""``python -m xgboost_tpu_torch <config> [key=value ...]``: the CLI
(``cli.py``; reference ``src/cli_main.cc``)."""
import sys

from .cli import main

sys.exit(main())
