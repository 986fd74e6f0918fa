# SPDX-License-Identifier: Apache-2.0
"""A dry run of every sharded path on an ``n``-rank ``(dp, tp)`` mesh: the
counterpart of the JAX package's ``dryrun_multichip``, at its tiny config.

One sharded train step, the sharded inference path (encode and
teacher-forced logits) and two fused streaming blocks through a real
:class:`~..engine.batcher.DeviceBatcher` on the sharded int8 stream table,
with ``tp = 2`` when ``n`` is even. The ranks are spawned by
:func:`.launch.run_ranks`.
"""

from __future__ import annotations

import asyncio

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from ..models.whisper.config import WhisperConfig
from .launch import run_ranks

__all__ = ["dryrun_multichip", "TINY"]

TINY = WhisperConfig(
    n_audio_ctx=64,
    n_audio_state=64,
    n_audio_head=4,  # divisible by tp
    n_audio_layer=2,
    n_vocab=512,
    n_text_ctx=16,
    n_text_state=64,
    n_text_head=4,
    n_text_layer=2,
)


def _rank(n_devices: int, device: str) -> dict:
    from ..engine.audio_ring import SessionAudioRing
    from ..engine.batcher import DeviceBatcher
    from ..models.whisper.model import decode_logits, encode, seeded_params
    from ..models.whisper.streaming import StreamTable
    from ..ops.vad import VAD_FRAME
    from .mesh import make_mesh, mesh_coords, shard_batch, shard_params
    from .serving import gather_rows, shard_audio_ring, shard_stream_table
    from .train import init_train_state, make_train_step

    dev = resolve_device(device)
    tp = 2 if n_devices % 2 == 0 else 1
    mesh = make_mesh(n_devices, tp=tp, device=dev)
    _, dp, _, _ = mesh_coords(mesh)
    cfg = TINY
    state = init_train_state(shard_params(mesh, seeded_params(cfg, device=dev), cfg))

    batch = dp * 2
    mel = torch.zeros((batch, cfg.n_audio_ctx * 2, cfg.n_mels), device=dev)
    tokens_in = torch.zeros((batch, 8), dtype=torch.int32, device=dev)
    mask = torch.ones((batch, 8), device=dev)
    mel, tokens_in, tokens_out, mask = shard_batch(mesh, mel, tokens_in, tokens_in, mask)
    state, loss = make_train_step(cfg, mesh=mesh)(state, mel, tokens_in, tokens_out, mask)
    assert torch.isfinite(loss).item(), f"non-finite loss: {loss}"
    assert state.step == 1

    # sharded inference: one batched window, encode + teacher-forced logits,
    # this dp rank's rows gathered over dp
    with torch.no_grad():
        logits = decode_logits(state.params, cfg, tokens_in, encode(state.params, cfg, mel))
    dp_group = mesh.get_group("dp")
    parts = [torch.empty_like(logits) for _ in range(dp)]
    dist.all_gather(parts, logits.contiguous(), group=dp_group)
    logits = torch.cat(parts)
    assert tuple(logits.shape) == (batch, 8, cfg.n_vocab), logits.shape
    assert torch.isfinite(logits).all().item(), "non-finite inference logits"

    # the fused streaming step on the sharded int8 table through a real
    # batcher: every rank submits the same rows, and the kind fires once all
    # are in, so the ranks' calls (and their collectives) pair up
    n_rows = dp
    ring = SessionAudioRing(max_slots=n_rows, ring_samples=1 << 14, device=dev)
    tbl = StreamTable(cfg, torch.float32, max_slots=n_rows, enc_t=64, dec_t=16, kv_int8=True, device=dev)
    for _ in range(n_rows):
        ring.alloc()
    shard_stream_table(mesh, tbl)
    shard_audio_ring(mesh, ring)
    prefix = np.asarray([1, 2, 3, 4], np.int32)

    async def engine_drive():
        batcher = DeviceBatcher(tick_ms=2.0, device=dev)
        batcher.start()
        kind = "stream_step:dryrun"
        batcher.register(kind, tbl.identity_step_fn(state.params, ring, ring.trash_slot(), 2), pad_to=n_rows,
                         gather_ms=60_000.0, host_inputs=True)
        batcher.set_expected(kind, n_rows)
        rng = np.random.RandomState(0)
        block_n = 8 * VAD_FRAME

        def meta_row(r, wpos, cstart, n_req, do_dec, do_rst):
            return np.concatenate([np.asarray([r, r, wpos, cstart, n_req, do_dec, do_rst], np.int32), prefix])

        # block 0: fused reset + append; block 1: chunk commit + decode
        for bi, (n_req, do_dec, do_rst) in enumerate([(0, 0, 1), (1, 1, 0)]):
            outs = await asyncio.gather(*(
                batcher.submit(kind, meta_row(r, bi * block_n, 0, n_req, do_dec, do_rst),
                               rng.randn(8, VAD_FRAME).astype(np.float32) * 0.2)
                for r in range(n_rows)
            ))
        calls = batcher.stats()["device_calls"]
        batcher.stop()
        return outs, calls

    outs, calls = asyncio.run(engine_drive())
    pos, n_tok = gather_rows(tbl.shard, tbl._enc_pos, tbl._n_tok)
    assert (pos == 8).all(), f"sharded fused step did not commit chunks: {pos}"
    assert (n_tok >= 4).all(), f"decode continuation did not run: {n_tok}"
    assert len(outs) == n_rows and calls == 2, (len(outs), calls)
    return {"loss": float(loss), "tp": tp, "dp": dp, "enc_pos": pos.tolist(), "n_tok": n_tok.tolist()}


def dryrun_multichip(n_devices: int, device=None, timeout_s: float = 120.0) -> list:
    """Run the dry run on ``n_devices`` spawned ranks of ``device`` (default
    ``cuda``, which raises without a card; ``"cpu"`` runs gloo ranks). On
    CUDA the backend is NCCL when every rank has a card of its own, else
    gloo (ranks sharing a card). Returns each rank's summary."""
    dev = resolve_device(device)
    backend = "gloo"
    if dev.type == "cuda" and n_devices <= torch.cuda.device_count():
        backend = "nccl"
    return run_ranks(_rank, n_devices, n_devices, dev.type, device=dev.type, backend=backend,
                     timeout_s=timeout_s)
