"""Tagged logger (port of fourdgs/utils/logging.py), printing to stderr."""

from __future__ import annotations

import sys
import time

_t0 = time.time()


def Log(*args, tag: str = "4DGS-SLAM") -> None:
    msg = " ".join(str(a) for a in args)
    print(f"[{time.time() - _t0:8.2f}s] {tag}: {msg}", file=sys.stderr)
