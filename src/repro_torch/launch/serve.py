"""The serving entry point's old name (port of ``repro/launch/serve.py``).

``repro.launch.serve`` grew two meanings, and so does the port's:

* ``python -m repro_torch.launch.serve_lm`` — the LM serving demo
  (batched prefill and decode); this module forwards there, so
  ``python -m repro_torch.launch.serve`` keeps working;
* ``python -m repro_torch.launch.serve_fl`` — federated rounds as a
  service over an arrival trace (``repro_torch.core.schedule``).
"""
from __future__ import annotations

import sys

from repro_torch.launch.serve_lm import main  # noqa: F401 (forwarded)

if __name__ == "__main__":
    print("note: `repro_torch.launch.serve` is the LM demo (also "
          "`repro_torch.launch.serve_lm`); the federated serving engine "
          "is `repro_torch.launch.serve_fl`.", file=sys.stderr)
    sys.exit(main())
