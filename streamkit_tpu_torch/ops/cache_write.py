# SPDX-License-Identifier: Apache-2.0
"""Windowed ring write into the streaming caches: a hand-written Hopper kernel.

Port of ``streamkit_tpu/ops/cache_write.py``. The streaming Whisper tables
append each fused call's candidate columns at a per-slot ring position::

    cache[g, s, f, (pos[s] + i) % T] = upd[g, s, f, i]    for i < lim[s]

in place; ``lim[s] = 0`` rows are untouched. The kernel
(``csrc/cache_write.cu``) replaces both TPU kernels there (``_kernel`` and
``_kernel4``); its header notes the design and the bound on an H100. It is
built with ``nvcc`` at first CUDA use (:mod:`._build`).

:func:`windowed_write_many` writes up to :data:`MAX_PAIRS` caches that share
``S``, ``pos`` and ``lim`` in one launch; :func:`windowed_write_groups` and
:func:`windowed_write` are its one-pair case. CUDA tensors launch the kernel,
and a pair it does not take raises; only CPU tensors go to the plain version,
:func:`windowed_write_reference` (index arithmetic and ``index_put_``, exact
like the kernel). ``lim`` above ``c`` counts as ``c``.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import _build

__all__ = ["windowed_write", "windowed_write_groups", "windowed_write_many", "windowed_write_reference", "supports",
           "MAX_PAIRS", "SOURCE"]

SOURCE = _build.Source("cache_write.cu", "nvcc")
MAX_PAIRS = 8  # the kernel's descriptor table
_MAX_SLOTS = 65535  # the grid's y extent
_lock = threading.Lock()


def supports(T: int, c: int) -> bool:
    """The kernel's limits: at least one candidate column and no more than
    the ring holds (a window wider than the ring would write a column
    twice). No tiling rule applies."""
    return 0 < c <= T < 2**31


def windowed_write_reference(cache, upd, pos, lim) -> torch.Tensor:
    """Plain version: ``cache [G, S, F, T]``, ``upd [G, S, F, c]``, ``pos``
    and ``lim`` ``[S]``. Writes ``cache`` in place and returns it."""
    T, c = cache.shape[-1], upd.shape[-1]
    i = torch.arange(c, device=cache.device)
    cols = (pos.to(cache.device, torch.long)[:, None] + i) % T  # [S, c]
    keep = i[None, :] < lim.to(cache.device, torch.long)[:, None]
    s_idx, i_idx = keep.nonzero(as_tuple=True)
    cache[:, s_idx, :, cols[s_idx, i_idx]] = upd[:, s_idx, :, i_idx]
    return cache


def _declare(lib) -> None:
    fn = lib.sk_windowed_write_many
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.sk_error_string.argtypes = [ctypes.c_int]
    lib.sk_error_string.restype = ctypes.c_char_p


def _check_pair(cache, upd) -> None:
    """What the kernel takes of one pair, whatever the device."""
    if cache.ndim != 4 or upd.ndim != 4 or upd.shape[:3] != cache.shape[:3]:
        raise ValueError(f"windowed_write: cache [G,S,F,T] and upd [G,S,F,c], got "
                         f"{tuple(cache.shape)} and {tuple(upd.shape)}")
    if upd.dtype != cache.dtype or cache.element_size() not in (1, 2, 4, 8):
        raise ValueError(f"windowed_write: one 1/2/4/8-byte dtype, got {cache.dtype} and {upd.dtype}")
    if not (cache.is_contiguous() and upd.is_contiguous()):
        raise ValueError("windowed_write: cache and upd must be contiguous")
    T, c = cache.shape[-1], upd.shape[-1]
    if not supports(T, c) or c * cache.element_size() > 2**20 or cache.shape[2] >= 2**31:
        raise ValueError(f"windowed_write: unsupported T={T}, c={c}")


def _check(cache, upd) -> None:
    if not (cache.is_cuda and upd.device == cache.device):
        raise ValueError("windowed_write: cache and upd must lie on one CUDA device")
    _check_pair(cache, upd)


def windowed_write_many(pairs, pos, lim) -> None:
    """``cache[g, s, f, (pos[s]+i) % T] = upd[g, s, f, i]`` for ``i <
    lim[s]``, in place, for every ``(cache [G, S, F, T], upd [G, S, F, c])``
    of ``pairs`` (1 to :data:`MAX_PAIRS`; ``G``, ``F``, ``T``, ``c`` and the
    dtype may differ between pairs, ``S``, ``pos`` and ``lim`` are shared).
    CUDA tensors launch the kernel once for all pairs; CPU tensors take
    :func:`windowed_write_reference` pair by pair. Raises on any pair the
    kernel does not take, whatever the device. ``windowed_write_groups.
    launches`` counts kernel launches."""
    pairs = [tuple(p) for p in pairs]
    if not 1 <= len(pairs) <= MAX_PAIRS:
        raise ValueError(f"windowed_write_many: 1 to {MAX_PAIRS} (cache, upd) pairs, got {len(pairs)}")
    dev = pairs[0][0].device
    if any(len(p) != 2 or t.device != dev for p in pairs for t in p):
        raise ValueError("windowed_write_many: every pair is (cache, upd), all on one device")
    for cache, upd in pairs:
        _check_pair(cache, upd)
    S = pairs[0][0].shape[1]
    if any(cache.shape[1] != S for cache, _ in pairs):
        raise ValueError(f"windowed_write_many: every cache must have S = {S} slots, got "
                         f"{[tuple(cache.shape) for cache, _ in pairs]}")
    pos, lim = torch.as_tensor(pos), torch.as_tensor(lim)
    if pos.shape != (S,) or lim.shape != (S,):
        raise ValueError(f"windowed_write: pos and lim must be [{S}], got {tuple(pos.shape)} and {tuple(lim.shape)}")
    if dev.type == "cpu":
        for cache, upd in pairs:
            windowed_write_reference(cache, upd, pos, lim)
        return
    _check(*pairs[0])
    if S > _MAX_SLOTS:
        raise ValueError(f"windowed_write: at most {_MAX_SLOTS} slots, got {S}")
    if S == 0 or not any(cache.shape[0] * cache.shape[2] for cache, _ in pairs):
        return  # no row to write: nothing to launch
    pos_d = pos.to(dev, torch.int32).contiguous()
    lim_d = lim.to(dev, torch.int32).contiguous()
    desc = (ctypes.c_longlong * (8 * len(pairs)))(*[
        v for cache, upd in pairs
        for v in (cache.data_ptr(), upd.data_ptr(), cache.element_size(), cache.shape[0], cache.shape[2],
                  cache.shape[3], upd.shape[3], 0)
    ])
    lib = _build.load(SOURCE, _declare)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.sk_windowed_write_many(len(pairs), desc, S, pos_d.data_ptr(), lim_d.data_ptr(), stream)
    if err:
        raise RuntimeError(f"windowed_write launch failed: {lib.sk_error_string(err).decode()}")
    with _lock:
        windowed_write_groups.launches += 1


def windowed_write_groups(cache, upd, pos, lim) -> torch.Tensor:
    """``cache[g, s, f, (pos[s]+i) % T] = upd[g, s, f, i]`` for ``i <
    lim[s]``, in place; returns ``cache``. ``G`` groups (layers) share each
    row's window. :func:`windowed_write_many` with one pair.
    ``windowed_write_groups.launches`` counts the kernel's launches, from
    every entry point."""
    windowed_write_many([(cache, upd)], pos, lim)
    return cache


windowed_write_groups.launches = 0


def windowed_write(cache, upd, pos, lim) -> torch.Tensor:
    """:func:`windowed_write_groups` with one group: ``cache [S, F, T]``,
    ``upd [S, F, c]``, in place."""
    windowed_write_groups(cache[None], upd[None], pos, lim)
    return cache
