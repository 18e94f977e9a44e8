"""Tree and time helpers (copies of `tree_paths` and `format_time` from
`pix2pix3d_tpu/utils/misc.py`)."""

from __future__ import annotations


def tree_paths(tree, prefix=()):
    """Yield (path_tuple, leaf) for a nested-dict pytree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_paths(v, prefix + (k,))
    else:
        yield prefix, tree


def format_time(seconds):
    """Human-readable duration (a copy of `pix2pix3d_tpu/utils/misc.py`'s)."""
    s = int(round(seconds))
    if s < 60:
        return f"{s}s"
    if s < 3600:
        return f"{s // 60}m {s % 60:02d}s"
    if s < 86400:
        return f"{s // 3600}h {(s % 3600) // 60:02d}m"
    return f"{s // 86400}d {(s % 86400) // 3600:02d}h"
