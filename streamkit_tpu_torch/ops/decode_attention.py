# SPDX-License-Identifier: Apache-2.0
"""The decode continuation's cross-attention over the int8 cross caches: a
hand-written Hopper kernel (K4).

The streaming decoder (``models/whisper/streaming.py`` ``_decode_core``)
attends one query row per batch row and head over the row's int8 cross K/V
(``T = enc_t`` columns, per-column f32 scales), visible below its encoder
horizon ``ep``. The reference writes it as a plain expression that XLA fuses;
eager PyTorch would write every cast of it to device memory. The kernel
(``csrc/decode_attention.cu``) reads the int8 values and their scales in
place; its header notes the design and the bound on an H100. It is built
with ``nvcc`` at first CUDA use (:mod:`._build`).

:func:`decode_cross_attention` launches the kernel for CUDA tensors and
raises on what it does not take; only CPU tensors go to the plain version,
:func:`decode_cross_attention_reference`, which is the decode step's own
expression.

Shapes (one layer, one decode step)::

    qs       [B, H, 1, hd]   model dtype (bf16 or f32), pre-scaled
    k8/v8    [B, H, hd, T]   int8 cross caches
    ks/vs    [B, H, T]       f32 per-column scales
    ep       [B]             encoder horizon per row (columns t < max(ep, 1))
    out      [B, H, 1, hd]   f32
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import _build
from .stream_attention import scaled_operand

__all__ = ["decode_cross_attention", "decode_cross_attention_reference", "supports", "SOURCE"]

SOURCE = _build.Source("decode_attention.cu", "nvcc")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = 232_448  # bytes of shared memory one block may use on an H100
_WARPS = 8
_lock = threading.Lock()


def _smem_bytes(T: int) -> int:
    """Shared memory of one block: the 8 warps' partial scores over ``T``
    columns (dynamic) and the two 8-float reductions (static)."""
    return _WARPS * T * 4 + 2 * _WARPS * 4


def supports(hd: int, T: int) -> bool:
    """The kernel's limits: a head dim of 32, 64 or 128 and the 8 warps'
    partial scores in shared memory (``T`` up to 7262). Any ``T`` below
    that."""
    return hd in (32, 64, 128) and 0 < T and _smem_bytes(T) <= _SMEM_LIMIT


def decode_cross_attention_reference(qs, k8, ks, v8, vs, ep, op_scale: float):
    """Plain version, the decode step's expression: f32 scores from
    dtype-rounded operands scaled per column after the dot, the horizon's
    mask, one softmax, probabilities rounded to the model dtype after the
    column scale is folded in."""
    dtype = qs.dtype
    T = k8.shape[-1]
    # max(ep, 1) keeps the softmax finite for rows not yet encoded (they are
    # inactive; this only avoids NaN in dead lanes)
    xmask = torch.where(
        torch.arange(T, device=qs.device)[None, :] < torch.clamp(ep, min=1)[:, None], 0.0, float("-inf")
    )[:, None, None, :]
    xs = torch.matmul(qs.float(), scaled_operand(k8, op_scale, dtype).float()) * ks[:, :, None, :]
    xp = torch.softmax(xs + xmask, dim=-1)
    p = (xp * vs[:, :, None, :]).to(dtype)
    return torch.matmul(p.float(), v8.to(dtype).transpose(-1, -2).float())


def _declare(lib) -> None:
    fn = lib.sk_decode_cross_attention
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.sk_error_string.argtypes = [ctypes.c_int]
    lib.sk_error_string.restype = ctypes.c_char_p


def _check(qs, k8, ks, v8, vs, ep) -> None:
    """Raise on what the kernel does not take: dtypes and shapes, then
    contiguity, then its limits, then the device."""
    args = dict(qs=qs, k8=k8, ks=ks, v8=v8, vs=vs, ep=ep)
    if qs.dtype not in _DTYPE_CODE:
        raise ValueError(f"decode_cross_attention: float32 or bfloat16 qs, got {qs.dtype}")
    if qs.dim() != 4 or qs.shape[2] != 1:
        raise ValueError(f"decode_cross_attention: qs must be [B, H, 1, hd], got {tuple(qs.shape)}")
    B, H, _, hd = qs.shape
    T = k8.shape[-1]
    want = dict(
        k8=((B, H, hd, T), torch.int8), v8=((B, H, hd, T), torch.int8),
        ks=((B, H, T), torch.float32), vs=((B, H, T), torch.float32),
        ep=((B,), torch.int32),
    )
    for name, (shape, dtype) in want.items():
        x = args[name]
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(
                f"decode_cross_attention: {name} must be {shape} {dtype}, got {tuple(x.shape)} {x.dtype}")
    if not all(x.is_contiguous() for x in args.values()):
        raise ValueError("decode_cross_attention: every tensor must be contiguous")
    if not supports(hd, T) or B * H >= 2**31:
        raise ValueError(f"decode_cross_attention: unsupported shape B={B} H={H} hd={hd} T={T}")
    if not qs.is_cuda or any(x.device != qs.device for x in args.values()):
        raise ValueError("decode_cross_attention: every tensor must lie on one CUDA device")


def decode_cross_attention(qs, k8, ks, v8, vs, ep, op_scale: float) -> torch.Tensor:
    """Cross-attention of one query row per (row, head) over the int8 cross
    caches below each row's horizon → ``[B, H, 1, hd]`` f32. CUDA tensors
    launch the kernel; CPU tensors take
    :func:`decode_cross_attention_reference`.
    ``decode_cross_attention.launches`` counts kernel launches."""
    if qs.device.type == "cpu":
        return decode_cross_attention_reference(qs, k8, ks, v8, vs, ep, op_scale)
    ep = ep.to(qs.device, torch.int32).contiguous()
    _check(qs, k8, ks, v8, vs, ep)
    B, H, _, hd = qs.shape
    T = k8.shape[-1]
    out = torch.empty((B, H, 1, hd), dtype=torch.float32, device=qs.device)
    op = float(torch.tensor(op_scale, dtype=qs.dtype))  # the dtype-rounded scale
    lib = _build.load(SOURCE, _declare)
    stream = torch.cuda.current_stream(qs.device).cuda_stream
    err = lib.sk_decode_cross_attention(
        _DTYPE_CODE[qs.dtype], qs.data_ptr(), k8.data_ptr(), ks.data_ptr(), v8.data_ptr(), vs.data_ptr(),
        ep.data_ptr(), out.data_ptr(), B, H, hd, T, op, stream,
    )
    if err:
        raise RuntimeError(f"decode_cross_attention launch failed: {lib.sk_error_string(err).decode()}")
    with _lock:
        decode_cross_attention.launches += 1
    return out


decode_cross_attention.launches = 0
