"""``python -m reflow_tpu_torch.subs`` — see
:mod:`reflow_tpu_torch.subs.cli`."""

from __future__ import annotations

import sys

from reflow_tpu_torch.subs.cli import main

if __name__ == "__main__":
    sys.exit(main())
