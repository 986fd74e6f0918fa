# SPDX-License-Identifier: Apache-2.0
"""Flash attention for the Whisper encoder: a hand-written Hopper kernel.

Port of ``streamkit_tpu/ops/attention.py``. The kernel
(``csrc/flash_attention.cu``) replaces both TPU kernels there
(``_flash_kernel`` and the library ``_lib_flash``); its header notes the
design and the bound on an H100. It is compiled with ``nvcc`` for
``sm_90a`` into a shared library on first CUDA use and loaded with
``ctypes`` (:mod:`._build`); importing this module needs neither ``nvcc``
nor a card.

The bf16 path reads q, k and v by TMA through 4-d tensor maps that the
kernel encodes on each call from :func:`tma_geometry` (host only, three
``cuTensorMapEncodeTiled`` calls; no copy of the head-split views).

:func:`flash_attention` launches the kernel for CUDA tensors and raises on
what the kernel does not take. Only CPU tensors go to the plain version,
:func:`attention_reference`.
"""

from __future__ import annotations

import ctypes
import math
import threading

import torch

from . import _build

__all__ = ["flash_attention", "attention_reference", "tma_geometry", "SOURCE"]

_LOG2E = math.log2(math.e)
SOURCE = _build.Source("flash_attention.cu", "nvcc")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()


def attention_reference(q, k, v, scale: float) -> torch.Tensor:
    """Plain attention (the kernel's CPU path and its oracle). q/k/v:
    ``[..., T, d]``; scores and softmax in f32, output in q's dtype."""
    scores = torch.matmul((q * scale).float(), (k.transpose(-1, -2) * scale).float())
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.matmul(probs, v).to(q.dtype)


def _declare(lib) -> None:
    fn = lib.sk_flash_attention
    fn.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
        + [ctypes.c_longlong] * 12 + [ctypes.c_float, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    lib.sk_error_string.argtypes = [ctypes.c_int]
    lib.sk_error_string.restype = ctypes.c_char_p


def tma_geometry(x: torch.Tensor):
    """The 4-d tensor map the bf16 kernel reads a ``[B, H, T, d]`` view
    through: its dims innermost first ``(d, T, H, B)`` and the element
    strides of ``(B, H, T)`` it is encoded with. A dim of size 1 is never
    stepped, so its stride is replaced by the tensor's extent (TMA checks it
    all the same). Raises ``ValueError`` on what TMA refuses: a head_dim
    stride other than 1, a base that is not 16-byte aligned, a stride that
    is no positive multiple of 16 bytes or not below 2**40 bytes, a dim of
    2**32 or more."""
    size = x.element_size()
    b, h, t, d = x.shape
    if x.stride(-1) != 1:
        raise ValueError(f"flash_attention: needs a unit head_dim stride, got {x.stride()}")
    if x.data_ptr() % 16:
        raise ValueError("flash_attention: TMA needs a 16-byte aligned base")
    extent = 1 + sum((n - 1) * st for n, st in zip(x.shape, x.stride()))
    extent = _round_up(extent * size, 16) // size
    strides = tuple(extent if n == 1 else st for n, st in zip((b, h, t), x.stride()[:3]))
    for st in strides:
        if st <= 0 or st * size % 16 or st * size >= 2**40:
            raise ValueError(
                f"flash_attention: TMA needs strides that are positive multiples of 16 bytes "
                f"below 2**40, got {x.stride()} x {size} bytes"
            )
    if max(x.shape) >= 2**32:
        raise ValueError(f"flash_attention: TMA dims must be below 2**32, got {tuple(x.shape)}")
    return (d, t, h, b), strides


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _check(q, k, v) -> list:
    """Raise on what the kernel does not take; else the element strides of
    q, k and v (each as batch, head, time) that it is launched with."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention: q, k and v must lie on one CUDA device")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: float32 or bfloat16 q/k/v, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.ndim != 4 or k.shape != v.shape or k.ndim != 4:
        raise ValueError("flash_attention: q [B,H,Tq,d], k and v [B,H,Tk,d]")
    b, h, tq, d = q.shape
    if k.shape[0] != b or k.shape[1] != h or k.shape[3] != d:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} vs k {tuple(k.shape)}")
    if d not in (64, 128) or tq == 0 or k.shape[2] == 0 or b * h > 65535:
        raise ValueError(f"flash_attention: unsupported shape {tuple(q.shape)}")
    if q.dtype == torch.bfloat16:  # TMA tensor maps
        return [st for x in (q, k, v) for st in tma_geometry(x)[1]]
    # f32: 16-byte vector loads of K/V rows
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(-1) != 1 or x.data_ptr() % 16 or any(s % 4 for s in x.stride()[:3]):
            raise ValueError(
                f"flash_attention: {name} needs a unit head_dim stride, a 16-byte "
                f"aligned base and strides in multiples of 4, got {x.stride()}"
            )
    return [st for x in (q, k, v) for st in x.stride()[:3]]


def flash_attention(q, k, v, scale: float) -> torch.Tensor:
    """Non-causal attention over ``[batch, heads, T, d]`` with ``scale``
    applied to both q and k (Whisper's ``d**-0.25``).

    CUDA tensors launch the kernel, reading q/k/v through their strides (the
    head-split views of ``[B, T, H*d]`` projections need no copy); the result
    is a ``[B, H, Tq, d]`` view of a ``[B, Tq, H, d]`` buffer, so merging the
    heads afterwards is free. CPU tensors take :func:`attention_reference`.
    ``flash_attention.launches`` counts kernel launches."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v, scale)
    if not scale > 0:  # the kernel takes the row max before scaling
        raise ValueError(f"flash_attention: needs scale > 0, got {scale}")
    strides = _check(q, k, v)
    lib = _build.load(SOURCE, _declare)
    b, h, tq, d = q.shape
    tk = k.shape[2]
    out = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.sk_flash_attention(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, h, tq, tk, d, *strides, *out.stride()[:3], scale * scale * _LOG2E, stream,
    )
    if err:
        raise RuntimeError(f"flash_attention launch failed: {lib.sk_error_string(err).decode()}")
    with _lock:
        flash_attention.launches += 1
    return out


flash_attention.launches = 0
