"""``python -m repro_torch.analysis`` → the checker's CLI."""
import sys

from repro_torch.analysis.cli import main

sys.exit(main())
