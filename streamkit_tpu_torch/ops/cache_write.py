# SPDX-License-Identifier: Apache-2.0
"""Windowed ring write into the streaming caches: a hand-written Hopper kernel.

Port of ``streamkit_tpu/ops/cache_write.py``. The streaming Whisper tables
append each fused call's candidate columns at a per-slot ring position::

    cache[g, s, f, (pos[s] + i) % T] = upd[g, s, f, i]    for i < lim[s]

in place; ``lim[s] = 0`` rows are untouched. The kernel
(``csrc/cache_write.cu``) replaces both TPU kernels there (``_kernel`` and
``_kernel4``); its header notes the design and the bound on an H100. It is
built with ``nvcc`` at first CUDA use (:mod:`._build`).

:func:`windowed_write_groups` launches the kernel for CUDA tensors and
raises on what it does not take; only CPU tensors go to the plain version,
:func:`windowed_write_reference` (index arithmetic and ``index_put_``, exact
like the kernel). ``lim`` above ``c`` counts as ``c``.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import _build

__all__ = ["windowed_write", "windowed_write_groups", "windowed_write_reference", "supports", "SOURCE"]

SOURCE = _build.Source("cache_write.cu", "nvcc")
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
    fn = lib.sk_windowed_write
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.sk_error_string.argtypes = [ctypes.c_int]
    lib.sk_error_string.restype = ctypes.c_char_p


def _check(cache, upd) -> None:
    if not (cache.is_cuda and upd.device == cache.device):
        raise ValueError("windowed_write: cache and upd must lie on one CUDA device")
    if cache.ndim != 4 or upd.ndim != 4 or upd.shape[:3] != cache.shape[:3]:
        raise ValueError(f"windowed_write: cache [G,S,F,T] and upd [G,S,F,c], got "
                         f"{tuple(cache.shape)} and {tuple(upd.shape)}")
    if upd.dtype != cache.dtype or cache.element_size() not in (1, 2, 4, 8):
        raise ValueError(f"windowed_write: one 1/2/4/8-byte dtype, got {cache.dtype} and {upd.dtype}")
    if not (cache.is_contiguous() and upd.is_contiguous()):
        raise ValueError("windowed_write: cache and upd must be contiguous")
    if not supports(cache.shape[-1], upd.shape[-1]) or cache.shape[1] >= 2**31 or cache.shape[2] >= 2**31:
        raise ValueError(f"windowed_write: unsupported T={cache.shape[-1]}, c={upd.shape[-1]}")


def windowed_write_groups(cache, upd, pos, lim) -> torch.Tensor:
    """``cache[g, s, f, (pos[s]+i) % T] = upd[g, s, f, i]`` for ``i <
    lim[s]``, in place; returns ``cache``. ``G`` groups (layers) share each
    row's window. CUDA tensors launch the kernel; CPU tensors take
    :func:`windowed_write_reference`. ``windowed_write_groups.launches``
    counts kernel launches."""
    if cache.device.type == "cpu":
        return windowed_write_reference(cache, upd, pos, lim)
    _check(cache, upd)
    G, S, F, T = cache.shape
    pos_d = torch.as_tensor(pos).to(cache.device, torch.int32).contiguous()
    lim_d = torch.as_tensor(lim).to(cache.device, torch.int32).contiguous()
    if pos_d.shape != (S,) or lim_d.shape != (S,):
        raise ValueError(f"windowed_write: pos and lim must be [{S}]")
    lib = _build.load(SOURCE, _declare)
    stream = torch.cuda.current_stream(cache.device).cuda_stream
    err = lib.sk_windowed_write(
        cache.element_size(), cache.data_ptr(), upd.data_ptr(), pos_d.data_ptr(), lim_d.data_ptr(),
        G, S, F, T, upd.shape[-1], stream,
    )
    if err:
        raise RuntimeError(f"windowed_write launch failed: {lib.sk_error_string(err).decode()}")
    with _lock:
        windowed_write_groups.launches += 1
    return cache


windowed_write_groups.launches = 0


def windowed_write(cache, upd, pos, lim) -> torch.Tensor:
    """:func:`windowed_write_groups` with one group: ``cache [S, F, T]``,
    ``upd [S, F, c]``, in place."""
    windowed_write_groups(cache[None], upd[None], pos, lim)
    return cache
