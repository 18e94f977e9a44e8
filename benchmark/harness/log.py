"""Progress lines on standard error, each with the seconds since the
process started."""

import sys
import time

START = time.perf_counter()


def log(msg):
    print(f"[{time.perf_counter() - START:8.2f} s] {msg}", file=sys.stderr, flush=True)
