# SPDX-License-Identifier: Apache-2.0
"""K2, the windowed cache write (``ops/cache_write.py``,
``csrc/cache_write.cu``): for each (cache, update) pair, row b's window of
``lim[b]`` columns from column ``pos[b]`` is copied from the update into
the cache. The bytes are the windows read and written, and each row's
position and length."""

KERNEL = r"windowed_write"


def nbytes(pairs, lims) -> int:
    """``pairs``: ``(groups, features, element bytes, columns)`` per cache
    (``groups`` is the layer count, ``features`` the bytes' row count);
    ``lims``: each row's window length, at most ``columns``."""
    total = 8 * len(lims)
    for groups, feats, esize, cols in pairs:
        total += 2 * groups * feats * esize * sum(min(int(x), cols) for x in lims)
    return total
