"""``python -m path_tracing__ray_tracer_tpu_torch [flags]``: the port's CLI
(``main.py``), on the card."""
import sys

from .main import main

sys.exit(main())
