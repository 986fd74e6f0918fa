# SPDX-License-Identifier: Apache-2.0
"""Flash attention for the Whisper encoder: hand-written Hopper kernels.

Port of ``streamkit_tpu/ops/attention.py``. The forward kernel
(``csrc/flash_attention.cu``) replaces both TPU kernels there
(``_flash_kernel`` and the library ``_lib_flash``); the backward kernels
(``csrc/flash_attention_bwd.cu``: a preprocess for D, then one pass over
key tiles for dQ, dK and dV, with dQ summed in a fixed order; bf16 on the
tensor cores by wgmma and TMA, f32 on the CUDA cores) replace the library
kernel's two backward ``pallas_call``s. Each source's header notes the
design and the bound on an H100. They are compiled with ``nvcc`` for ``sm_90a`` into shared libraries
on first CUDA use and loaded with ``ctypes`` (:mod:`._build`); importing
this module needs neither ``nvcc`` nor a card.

The bf16 paths read q, k and v (the backward also dO) by TMA through 4-d
tensor maps that the kernel encodes on each call from :func:`tma_geometry`
(host only, one ``cuTensorMapEncodeTiled`` call a tensor; no copy of the
head-split views).

:func:`flash_attention` launches the kernel for CUDA tensors and raises on
what the kernel does not take. Only CPU tensors go to the plain version,
:func:`attention_reference` (autograd differentiates it there). On CUDA,
when grad mode is on and an input requires grad, it goes through
:class:`FlashAttention`: the forward also stores the rows' log-sum-exp and
the backward launches the two backward kernels. Otherwise it makes the one
launch it always made, so the serving paths pay nothing.
"""

from __future__ import annotations

import ctypes
import math
import threading

import torch
from torch.autograd.function import once_differentiable

from . import _build

__all__ = [
    "flash_attention",
    "flash_attention_lse",
    "flash_attention_backward",
    "FlashAttention",
    "attention_reference",
    "attention_lse_reference",
    "attention_backward_reference",
    "attention_backward_preprocess_reference",
    "attention_backward_main_reference",
    "tma_geometry",
    "SOURCE",
    "BWD_SOURCE",
]

_LOG2E = math.log2(math.e)
SOURCE = _build.Source("flash_attention.cu", "nvcc")
BWD_SOURCE = _build.Source("flash_attention_bwd.cu", "nvcc")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()


def attention_reference(q, k, v, scale: float) -> torch.Tensor:
    """Plain attention (the kernel's CPU path and its oracle). q/k/v:
    ``[..., T, d]``; scores and softmax in f32, output in q's dtype."""
    scores = torch.matmul((q * scale).float(), (k.transpose(-1, -2) * scale).float())
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.matmul(probs, v).to(q.dtype)


def attention_lse_reference(q, k, v, scale: float):
    """:func:`attention_reference` and the rows' base-2 log-sum-exp of the
    scaled scores, ``[..., Tq]`` f32: what :func:`flash_attention_lse`
    returns (the kernel's row statistic, ``csrc/flash_attention.cu``)."""
    scores = torch.matmul((q * scale).float(), (k.transpose(-1, -2) * scale).float())
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.matmul(probs, v).to(q.dtype), torch.logsumexp(scores, dim=-1) * _LOG2E


def _probs(q32, k32, lse, scale: float):
    """P rebuilt from the row statistic, as the backward kernels do."""
    return torch.exp2(torch.matmul(q32, k32.transpose(-1, -2)) * (scale * scale * _LOG2E) - lse[..., None])


def _rounded(x, dtype):
    """``x`` rounded to ``dtype`` and back to f32: where the bf16 kernels
    round P and dS to feed the tensor cores (a no-op at f32)."""
    return x.to(dtype).float()


def attention_backward_preprocess_reference(o, do):
    """The preprocess kernel's plain version: D = rowsum(dO∘O), ``[..., Tq]``
    f32 (the library backward's ``di``, computed outside its kernels)."""
    return (do.float() * o.float()).sum(-1)


def attention_backward_main_reference(q, k, v, do, lse, delta, scale: float):
    """The main kernel's plain version, one pass given D (``delta``) →
    ``(dq, dk, dv)`` in the inputs' dtype."""
    q32, k32, v32, do32 = q.float(), k.float(), v.float(), do.float()
    p = _probs(q32, k32, lse, scale)
    ds = _rounded(p * (torch.matmul(do32, v32.transpose(-1, -2)) - delta[..., None]), q.dtype)
    dq = torch.matmul(ds, k32) * (scale * scale)
    dk = torch.matmul(ds.transpose(-1, -2), q32) * (scale * scale)
    dv = torch.matmul(_rounded(p, q.dtype).transpose(-1, -2), do32)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def attention_backward_reference(q, k, v, o, do, lse, scale: float):
    """Plain backward of :func:`flash_attention` (the backward kernels' CPU
    path and their oracle): the output ``o``, its gradient ``do`` and the row
    statistic ``lse`` of the forward → ``(dq, dk, dv)`` in the inputs'
    dtype, computed in f32:

    D = rowsum(dO∘O), P = 2^(s²·log2(e)·QKᵀ − lse), dV = PᵀdO,
    dS = P∘(dO·Vᵀ − D), dQ = s²·dS·K, dK = s²·dSᵀ·Q,

    with P and dS rounded to the inputs' dtype before the products they feed
    (dV, dQ, dK), as the bf16 kernel rounds them for the tensor cores. Its
    two halves are the two kernels' plain versions: the preprocess (D), then
    the main pass."""
    delta = attention_backward_preprocess_reference(o, do)
    return attention_backward_main_reference(q, k, v, do, lse, delta, scale)


def _declare(lib) -> None:
    fn = lib.sk_flash_attention
    fn.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
        + [ctypes.c_longlong] * 12 + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    lib.sk_error_string.argtypes = [ctypes.c_int]
    lib.sk_error_string.restype = ctypes.c_char_p


def _declare_bwd(lib) -> None:
    fn = lib.sk_flash_attention_bwd
    fn.argtypes = (
        [ctypes.c_int] * 2 + [ctypes.c_void_p] * 7 + [ctypes.c_longlong] + [ctypes.c_void_p] * 3
        + [ctypes.c_int] * 5 + [ctypes.c_void_p, ctypes.c_float, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    lib.sk_bwd_error_string.argtypes = [ctypes.c_int]
    lib.sk_bwd_error_string.restype = ctypes.c_char_p


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


def _forward(q, k, v, scale: float, with_lse: bool):
    """Launch K1 on CUDA tensors → (out, lse or None)."""
    if not scale > 0:  # the kernel takes the row max before scaling
        raise ValueError(f"flash_attention: needs scale > 0, got {scale}")
    strides = _check(q, k, v)
    lib = _build.load(SOURCE, _declare)
    b, h, tq, d = q.shape
    tk = k.shape[2]
    out = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device) if with_lse else None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.sk_flash_attention(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, h, tq, tk, d, *strides, *out.stride()[:3], scale * scale * _LOG2E,
        None if lse is None else lse.data_ptr(), stream,
    )
    if err:
        raise RuntimeError(f"flash_attention launch failed: {lib.sk_error_string(err).decode()}")
    with _lock:
        flash_attention.launches += 1
    return out, lse


def flash_attention(q, k, v, scale: float) -> torch.Tensor:
    """Non-causal attention over ``[batch, heads, T, d]`` with ``scale``
    applied to both q and k (Whisper's ``d**-0.25``).

    CUDA tensors launch the kernel, reading q/k/v through their strides (the
    head-split views of ``[B, T, H*d]`` projections need no copy); the result
    is a ``[B, H, Tq, d]`` view of a ``[B, Tq, H, d]`` buffer, so merging the
    heads afterwards is free. With grad mode on and an input that requires
    grad, the call goes through :class:`FlashAttention` (one forward launch
    that also stores the row statistic; the backward kernels on
    ``backward()``). CPU tensors take :func:`attention_reference`.
    ``flash_attention.launches`` counts forward launches."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v, scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, scale)
    return _forward(q, k, v, scale, with_lse=False)[0]


flash_attention.launches = 0


def flash_attention_lse(q, k, v, scale: float):
    """:func:`flash_attention` that also returns the rows' base-2
    log-sum-exp, ``[B, H, Tq]`` f32 (``csrc/flash_attention.cu``'s header
    defines it). CUDA tensors launch K1 with the store on (one launch of
    ``flash_attention.launches``); CPU tensors take
    :func:`attention_lse_reference`."""
    if q.device.type == "cpu":
        return attention_lse_reference(q, k, v, scale)
    return _forward(q, k, v, scale, with_lse=True)


_BM = 64  # query rows per tile of the backward kernels


def _work_floats(tq: int, d: int) -> int:
    """f32 elements of one head's backward workspace (``work_floats`` in
    ``csrc/flash_attention_bwd.cu``): lse and D padded to whole 64-row query
    tiles, the dQ accumulator, the dQ counters rounded up to 16 bytes."""
    nq = -(-tq // _BM)
    return nq * _BM * (2 + d) + _round_up(nq, 4)


def _bwd_launch(which: int, q, k, v, o, do, lse, work, dq, dk, dv, scale: float, strides, spin=None) -> None:
    lib = _build.load(BWD_SOURCE, _declare_bwd)
    b, h, tq, d = q.shape
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.sk_flash_attention_bwd(
        which, _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), work.data_ptr(), work.shape[-1], dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, h, tq, k.shape[2], d, ctypes.cast(strides, ctypes.c_void_p), scale * scale * _LOG2E, scale * scale,
        None if spin is None else spin.data_ptr(), stream,
    )
    if err:
        raise RuntimeError(f"flash_attention backward launch failed: {lib.sk_bwd_error_string(err).decode()}")


def _rows16(x) -> bool:
    """A 16-byte aligned base and batch, head and time strides (dims of size
    1 aside): what the main kernel's loads of dO need (bf16: TMA; f32:
    16-byte cp.async)."""
    size = x.element_size()
    return x.data_ptr() % 16 == 0 and all(
        n == 1 or st * size % 16 == 0 for n, st in zip(x.shape[:3], x.stride()[:3]))


def _bwd_inputs(q, k, v, o, do, lse):
    """Check the backward's operands → ``(do, strides)``: ``do`` laid out as
    the kernels read it (autograd may hand over any layout; a copy only
    then) and the (batch, head, time) element strides of q, k, v, o, dO and
    the dq, dk, dv buffers that both launches take (bf16 q, k, v and dO as
    their TMA maps are encoded, see :func:`tma_geometry`). q, k and v pass
    the forward's checks (bf16: TMA's 16-byte alignment)."""
    qkv = _check(q, k, v)
    for x in (o, do):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"flash_attention backward: {tuple(x.shape)} {x.dtype} vs q {tuple(q.shape)} {q.dtype}")
    if o.stride(-1) != 1:
        raise ValueError(f"flash_attention backward: o needs a unit head_dim stride, got {o.stride()}")
    if lse.shape != q.shape[:3] or lse.dtype != torch.float32 or not lse.is_contiguous() or lse.device != q.device:
        raise ValueError(f"flash_attention backward: lse must be a contiguous f32 {tuple(q.shape[:3])}")
    if do.stride(-1) != 1 or not _rows16(do):
        do = do.contiguous()
    b, h, tq, d = q.shape
    tk = k.shape[2]
    do_st = tma_geometry(do)[1] if q.dtype == torch.bfloat16 else do.stride()[:3]
    heads = [(t * h * d, d, h * d) for t in (tq, tk, tk)]  # the _like_heads buffers of dq, dk, dv
    return do, (ctypes.c_longlong * 24)(*qkv, *o.stride()[:3], *do_st, *(st for x in heads for st in x))


def _like_heads(x: torch.Tensor) -> torch.Tensor:
    """An empty ``[B, H, T, d]`` view of a ``[B, T, H, d]`` buffer (as the
    forward writes O, so the head split's backward copies nothing)."""
    b, h, t, d = x.shape
    return torch.empty((b, t, h, d), dtype=x.dtype, device=x.device).transpose(1, 2)


def _bwd_preprocess(q, k, v, o, do, lse, strides):
    """The preprocess kernel on operands :func:`_bwd_inputs` checked
    (``strides`` what it returned): D = rowsum(dO∘O) of every query row →
    ``(work, delta)``: the main kernel's workspace, ``[B, H, W]`` f32,
    which holds the row statistic, D and the ordered dQ's accumulator and
    counters (``csrc/flash_attention_bwd.cu``), and D, a ``[B, H, Tq]``
    view of it. ``.launches`` counts launches."""
    b, h, tq, d = q.shape
    work = torch.empty((b, h, _work_floats(tq, d)), dtype=torch.float32, device=q.device)
    _bwd_launch(0, q, k, v, o, do, lse, work, q, k, v, 0.0, strides)  # it writes only the workspace
    with _lock:
        _bwd_preprocess.launches += 1
    nq = -(-tq // _BM) * _BM  # D follows the row statistic, padded to whole query tiles
    return work, work[..., nq:nq + tq]


_bwd_preprocess.launches = 0


def _bwd_main(q, k, v, o, do, lse, work, scale: float, strides, spin):
    """The main kernel, on the workspace :func:`_bwd_preprocess` has just
    filled → ``(dq, dk, dv)`` in the inputs' dtype, as ``[B, H, T, d]``
    views of ``[B, T, H, d]`` buffers (``o`` is read for nothing but its
    strides). ``.launches`` counts launches."""
    dq, dk, dv = _like_heads(q), _like_heads(k), _like_heads(v)
    _bwd_launch(1, q, k, v, o, do, lse, work, dq, dk, dv, scale, strides, spin)
    with _lock:
        _bwd_main.launches += 1
    return dq, dk, dv


_bwd_main.launches = 0


def _flash_backward(q, k, v, o, do, lse, scale: float, spin=None):
    """Both backward kernels on CUDA tensors, the operands checked once →
    ``(dq, dk, dv, delta)``, ``delta`` the preprocess's D. ``spin``: an
    int64 ``[1]`` on the card that the main kernel adds the cycles it waits
    on dQ counters to (a measurement; None on every path)."""
    do, strides = _bwd_inputs(q, k, v, o, do, lse)
    work, delta = _bwd_preprocess(q, k, v, o, do, lse, strides)
    return (*_bwd_main(q, k, v, o, do, lse, work, scale, strides, spin), delta)


def flash_attention_backward(q, k, v, o, do, lse, scale: float):
    """Gradients of :func:`flash_attention` → ``(dq, dk, dv)`` in the inputs'
    dtype. CUDA tensors launch the preprocess (D; ``_bwd_preprocess.launches``)
    and then the main pass (dQ in a fixed order, dK, dV;
    ``_bwd_main.launches``), so two runs give the same bits; the results are
    ``[B, H, T, d]`` views of ``[B, T, H, d]`` buffers. CPU tensors take
    :func:`attention_backward_reference`, the composition of the two kernels'
    plain halves. A failed build or launch raises."""
    if q.device.type == "cpu":
        return attention_backward_reference(q, k, v, o, do, lse, scale)
    return _flash_backward(q, k, v, o, do, lse, scale)[:3]


class FlashAttention(torch.autograd.Function):
    """K1 with its backward kernels: ``FlashAttention.apply(q, k, v, scale)``.
    The forward launches K1 with the row statistic stored and saves q, k, v,
    O and lse; the backward launches the preprocess and main kernels (first-order
    only). CPU tensors run the plain versions of both."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        # the backward takes whatever the forward's checks let through, so a
        # refusal comes here, while the graph is recorded, never in backward()
        out, lse = flash_attention_lse(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, out, do, lse, ctx.scale)
        return dq, dk, dv, None
