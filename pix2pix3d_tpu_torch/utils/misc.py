"""Tree helpers (a copy of `tree_paths` from `pix2pix3d_tpu/utils/misc.py`)."""

from __future__ import annotations


def tree_paths(tree, prefix=()):
    """Yield (path_tuple, leaf) for a nested-dict pytree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_paths(v, prefix + (k,))
    else:
        yield prefix, tree
