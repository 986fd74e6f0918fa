# SPDX-License-Identifier: Apache-2.0
"""Streaming-encoder attention over an int8 K/V history: a hand-written
Hopper kernel.

Port of ``streamkit_tpu/ops/stream_attention.py``. The fused stream step's
encoder attends each call's ``c = 8·n_chunks`` new positions per row over
(a) the row's cached int8 K/V history (``T = enc_t`` columns, per-column f32
scales) and (b) this call's own candidate columns, block-causal within the
call. The kernel (``csrc/stream_attention.cu``) replaces the TPU kernel
``_kernel``; its header notes the design and the bound on an H100. It is
built with ``nvcc`` at first CUDA use (:mod:`._build`).

:func:`history_attention` launches the kernel for CUDA tensors and raises on
what it does not take; only CPU tensors go to the plain version,
:func:`history_attention_reference`, which is the reference's formulation.

Shapes (one layer, one call)::

    qs       [B, H, c, hd]   model dtype (bf16 or f32), pre-scaled
    k8/v8    [B, H, hd, T]   int8 history
    ks/vs    [B, H, T]       f32 per-column scales
    ck8/cv8  [B, H, hd, c]   int8 candidate columns (this call)
    cks/cvs  [B, H, c]       f32 candidate scales
    pos      [B]             valid-history bound per row
    out      [B, H, c, hd]   f32
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import _build

__all__ = ["history_attention", "history_attention_reference", "scaled_operand", "supports", "SOURCE"]

SOURCE = _build.Source("stream_attention.cu", "nvcc")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = 232_448  # bytes of shared memory one block may use on an H100
_lock = threading.Lock()


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _smem_bytes(hd: int, T: int, c: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """Shared memory of one block, as the kernel lays it out. bf16 (tensor
    cores, ``Layout`` in the source): a ring of int8 tiles (128 columns,
    rows of 144 bytes, and their f32 scales; 4 stages, 8 at hd = 32, 2 at
    hd = 128), one dequantised bf16 K tile, the candidate K and V columns,
    the 16 rows' scores over the history tiles and the candidates, the row
    statistics of 8 warps and the candidates' scales. f32 (CUDA cores): the
    8 rows' queries and ``T + c`` scores and one int8 V tile."""
    if dtype == torch.float32:
        return (8 * hd + 8 * (T + c)) * 4 + hd * 68
    stages = {32: 8, 64: 4, 128: 2}.get(hd, 4)
    c_pad = _round_up(c, 16)
    ring = stages * (hd * 144 + 128 * 4)
    kb = hd * 136 * 2
    cand = _round_up(2 * hd * (c_pad + 4), 16)
    sp = 16 * (_round_up(T, 128) + c_pad + 8) * 4
    return ring + kb + cand + sp + 2 * 8 * 16 * 4 + 2 * c_pad * 4 + 16  # + static: the row ranking


def supports(H: int, hd: int, T: int, c: int, dtype: torch.dtype = torch.bfloat16) -> bool:
    """The kernel's limits: whole 8-row chunks of queries, a head dim of 32,
    64 or 128, and the rows' ``T + c`` scores in shared memory (bf16: 16 rows
    per block, T up to about 2500 at hd = 64; f32: 8 rows, about 7000). Any
    ``T`` below that, tile multiple or not."""
    return (c > 0 and c % 8 == 0 and hd in (32, 64, 128) and H > 0
            and _smem_bytes(hd, T, c, dtype) <= _SMEM_LIMIT)


def scaled_operand(x, op_scale: float, dtype: torch.dtype) -> torch.Tensor:
    """``x.astype(dtype) * op_scale`` as the reference rounds it: the scale
    is a weakly typed scalar there, so it is rounded to ``dtype`` first and
    the product is rounded to ``dtype``."""
    return x.to(dtype) * torch.tensor(op_scale, dtype=dtype, device=x.device)


def history_attention_reference(qs, k8, ks, v8, vs, ck8, cks, cv8, cvs, pos, op_scale: float):
    """Plain version, the reference's ``_encode_core`` formulation: f32 scores
    from dtype-rounded operands, one softmax over ``T + c``, probabilities
    rounded to the model dtype after the column scale is folded in."""
    dtype = qs.dtype
    T, c = k8.shape[-1], qs.shape[2]
    q = qs.float()
    s_h = torch.matmul(q, scaled_operand(k8, op_scale, dtype).float()) * ks[:, :, None, :]
    s_c = torch.matmul(q, scaled_operand(ck8, op_scale, dtype).float()) * cks[:, :, None, :]
    col = torch.arange(T, device=qs.device)
    hist_mask = torch.where(col[None, :] < pos.to(qs.device)[:, None], 0.0, float("-inf"))
    j = torch.arange(c, device=qs.device)
    cand_mask = torch.where(j[None, :] < ((j // 8 + 1) * 8)[:, None], 0.0, float("-inf"))
    scores = torch.cat([s_h + hist_mask[:, None, None, :], s_c + cand_mask], dim=-1)
    probs = torch.softmax(scores, dim=-1)
    p_h, p_c = probs[..., :T], probs[..., T:]
    out_h = torch.matmul((p_h * vs[:, :, None, :]).to(dtype).float(), v8.float().transpose(-1, -2))
    out_c = torch.matmul((p_c * cvs[:, :, None, :]).to(dtype).float(), cv8.float().transpose(-1, -2))
    return out_h + out_c


def _declare(lib) -> None:
    fn = lib.sk_history_attention
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.sk_error_string.argtypes = [ctypes.c_int]
    lib.sk_error_string.restype = ctypes.c_char_p


def _check(qs, k8, ks, v8, vs, ck8, cks, cv8, cvs, pos) -> None:
    args = dict(qs=qs, k8=k8, ks=ks, v8=v8, vs=vs, ck8=ck8, cks=cks, cv8=cv8, cvs=cvs, pos=pos)
    if not qs.is_cuda or any(x.device != qs.device for x in args.values()):
        raise ValueError("history_attention: every tensor must lie on one CUDA device")
    if qs.dtype not in _DTYPE_CODE:
        raise ValueError(f"history_attention: float32 or bfloat16 qs, got {qs.dtype}")
    B, H, c, hd = qs.shape
    T = k8.shape[-1]
    want = dict(
        k8=((B, H, hd, T), torch.int8), v8=((B, H, hd, T), torch.int8),
        ks=((B, H, T), torch.float32), vs=((B, H, T), torch.float32),
        ck8=((B, H, hd, c), torch.int8), cv8=((B, H, hd, c), torch.int8),
        cks=((B, H, c), torch.float32), cvs=((B, H, c), torch.float32),
        pos=((B,), torch.int32),
    )
    for name, (shape, dtype) in want.items():
        x = args[name]
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(f"history_attention: {name} must be {shape} {dtype}, got {tuple(x.shape)} {x.dtype}")
    if not all(x.is_contiguous() for x in args.values()):
        raise ValueError("history_attention: every tensor must be contiguous")
    if not supports(H, hd, T, c, qs.dtype) or B * H >= 2**31:
        raise ValueError(f"history_attention: unsupported shape H={H} hd={hd} T={T} c={c}")


def history_attention(qs, k8, ks, v8, vs, ck8, cks, cv8, cvs, pos, op_scale: float) -> torch.Tensor:
    """Attention of ``qs`` over the int8 history and this call's candidates →
    ``[B, H, c, hd]`` f32. CUDA tensors launch the kernel; CPU tensors take
    :func:`history_attention_reference`. ``history_attention.launches``
    counts kernel launches."""
    if qs.device.type == "cpu":
        return history_attention_reference(qs, k8, ks, v8, vs, ck8, cks, cv8, cvs, pos, op_scale)
    pos = pos.to(qs.device, torch.int32).contiguous()
    _check(qs, k8, ks, v8, vs, ck8, cks, cv8, cvs, pos)
    B, H, c, hd = qs.shape
    T = k8.shape[-1]
    out = torch.empty((B, H, c, hd), dtype=torch.float32, device=qs.device)
    op = float(torch.tensor(op_scale, dtype=qs.dtype))  # the dtype-rounded scale
    lib = _build.load(SOURCE, _declare)
    stream = torch.cuda.current_stream(qs.device).cuda_stream
    err = lib.sk_history_attention(
        _DTYPE_CODE[qs.dtype], qs.data_ptr(), k8.data_ptr(), ks.data_ptr(), v8.data_ptr(), vs.data_ptr(),
        ck8.data_ptr(), cks.data_ptr(), cv8.data_ptr(), cvs.data_ptr(), pos.data_ptr(), out.data_ptr(),
        B, H, c, hd, T, op, stream,
    )
    if err:
        raise RuntimeError(f"history_attention launch failed: {lib.sk_error_string(err).decode()}")
    with _lock:
        history_attention.launches += 1
    return out


history_attention.launches = 0
