# SPDX-License-Identifier: Apache-2.0
"""Sharded serving on the port (mirrors tests/test_parallel_serving.py): the
fused streaming step on a dp×tp mesh of 8 gloo ranks with sharded weights,
stream slots and audio rings, held against the JAX package's single-device
run (in this process) and the port's one-rank run; and
``SttServingEngine(mesh=)`` reaching a final in both final modes.

The ranks import this module, so it imports only the port at its top (the
JAX package is imported inside the fixtures). One spawn runs the four
fused-step scenarios, one more the two engine runs.
"""

import asyncio
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from streamkit_tpu_torch.engine.audio_ring import SessionAudioRing
from streamkit_tpu_torch.models.whisper.config import WhisperConfig
from streamkit_tpu_torch.models.whisper.load import params_from_numpy
from streamkit_tpu_torch.models.whisper.streaming import StreamTable
from streamkit_tpu_torch.ops.vad import VAD_FRAME
from streamkit_tpu_torch.parallel import make_mesh, run_ranks
from streamkit_tpu_torch.parallel.serving import gather_rows, serving_input_shardings, shard_serving_state
from test_torch_parallel import affine_random

torch.set_num_threads(2)  # pytest runs files in parallel workers: leave cores to the others

DIMS = dict(n_mels=80, n_audio_ctx=64, n_audio_state=64, n_audio_head=4, n_audio_layer=2, n_vocab=256,
            n_text_ctx=32, n_text_state=64, n_text_head=4, n_text_layer=2)
CFG = WhisperConfig(**DIMS)
PREFIX = np.asarray([1, 2, 3, 4], np.int32)
CASES = [(1, 1), (2, 1), (2, 2)]  # (tp, rows per dp rank); (2, 2): 8 rows over dp = 4
WORLD = 8
DEADLINE_S = 120


def _blocks(n_rows: int) -> np.ndarray:
    return np.random.RandomState(0).randn(2, n_rows, 8, VAD_FRAME).astype(np.float32) * 0.2


def _run_steps(params, table, ring, n_rows: int) -> None:
    """Two fused blocks on ``n_rows`` sessions (reset + append, then one
    chunk committed and decoded), as the reference test drives them."""
    blocks = _blocks(n_rows)
    for sid in range(n_rows):
        table.reset(sid, PREFIX)
    block_n = 8 * VAD_FRAME
    rows = list(range(n_rows))
    table.step(params, ring, rows, rows, [0] * n_rows, [0] * n_rows, [0] * n_rows, [False] * n_rows, blocks[0],
               max_steps=4, do_reset=[True] * n_rows, prefix_b=[PREFIX] * n_rows)
    table.step(params, ring, rows, rows, [block_n] * n_rows, [0] * n_rows, [1] * n_rows, [True] * n_rows,
               blocks[1], max_steps=4)


def _state(n_rows: int, kv_int8: bool):
    ring = SessionAudioRing(max_slots=n_rows, ring_samples=1 << 14, device="cpu")
    tbl = StreamTable(CFG, torch.float32, max_slots=n_rows, enc_t=64, dec_t=32, kv_int8=kv_int8, device="cpu")
    for _ in range(n_rows):
        ring.alloc()
    return ring, tbl


def _table_rows(tbl) -> tuple:
    """(tokens, n_tok, enc_pos) of every slot, host numpy."""
    if tbl.shard is None:
        return tuple(x.numpy() for x in (tbl._tokens, tbl._n_tok, tbl._enc_pos))
    return gather_rows(tbl.shard, tbl._tokens, tbl._n_tok, tbl._enc_pos)


def _fused_scenarios(trees: dict) -> dict:
    rank = dist.get_rank()
    out = {}
    for tp, per in CASES:
        mesh = make_mesh(WORLD, tp=tp, device="cpu")
        n_rows = (WORLD // tp) * per
        ring, tbl = _state(n_rows, kv_int8=False)
        params = shard_serving_state(mesh, params_from_numpy(trees[3], CFG, device="cpu"), table=tbl, ring=ring)
        _run_steps(params, tbl, ring, n_rows)
        got = _table_rows(tbl)
        # the rows of a slot-ordered batch this dp rank runs are its slots
        meta_rows, frame_rows = serving_input_shardings(mesh, n_rows)
        own = np.flatnonzero(tbl.shard.owner(np.arange(n_rows)) == tbl.shard.rank)
        if not (np.array_equal(np.arange(n_rows)[meta_rows], own) and meta_rows == frame_rows):
            raise AssertionError(f"serving_input_shardings {meta_rows} against slots {own}")
        if rank == 0:
            ring1, tbl1 = _state(n_rows, kv_int8=False)
            _run_steps(params_from_numpy(trees[3], CFG, device="cpu"), tbl1, ring1, n_rows)
            out[(tp, per)] = {"mesh": got, "one_rank": _table_rows(tbl1),
                              "local_caches": tuple(tbl._enc_k.shape), "local_ring": tuple(ring._ring.shape)}
    # the int8 (q8, scale) caches shard and execute
    mesh = make_mesh(WORLD, tp=2, device="cpu")
    ring, tbl = _state(4, kv_int8=True)
    params = shard_serving_state(mesh, params_from_numpy(trees[5], CFG, device="cpu"), table=tbl, ring=ring)
    _run_steps(params, tbl, ring, 4)
    out["int8"] = {"rows": _table_rows(tbl), "local_q8": tuple(tbl._enc_k[0].shape),
                   "local_scale": tuple(tbl._enc_k[1].shape)}
    dist.barrier()
    return out if rank == 0 else None


def _engine_rank(modes) -> dict:
    """``SttServingEngine(mesh=)``, whisper tiny at f32 on dp 4 × tp 2, once
    per final mode: rank 0 serves one session, the other ranks follow."""
    from streamkit_tpu_torch.engine.stt_serving import SttServingEngine
    from streamkit_tpu_torch.utils.speechsynth import synth_speech_with_plan

    os.environ.setdefault("SK_STREAM_PAD", "4")
    os.environ.setdefault("SK_RING_SLOTS", "8")
    mesh = make_mesh(WORLD, tp=2, device="cpu")
    out = {}
    for mode in modes:
        eng = SttServingEngine(model_size="tiny", dtype="float32", max_sessions=4, final_mode=mode, mesh=mesh,
                               device="cpu")
        if dist.get_rank() != 0:
            asyncio.run(eng.start())
            eng.follow()
            continue

        async def main():
            await eng.start()
            events = []
            sid = eng.open_session(events.append)
            audio, _ = synth_speech_with_plan(5.0, 16_000, seed=3)
            eng.push(sid, audio.astype(np.float32))
            eng.push(sid, np.zeros(16_000, np.float32))
            deadline = asyncio.get_running_loop().time() + 60
            while asyncio.get_running_loop().time() < deadline:
                if any(e["type"] == "final" for e in events):
                    break
                await asyncio.sleep(0.2)
            eng.close_session(sid)
            await eng.stop()
            return events

        events = asyncio.run(main())
        out[mode] = {"types": [e["type"] for e in events],
                     "finals": [e["text"] for e in events if e["type"] == "final"],
                     "idle": eng.idle(), "free_stream_rows": len(eng._tbl._free),
                     "table_rows": eng._tbl.max_slots, "finals_stream": eng.finals_stream,
                     "finals_fallback": eng.finals_fallback,
                     "calls": eng.batcher.stats()["kinds"]}
    return out if dist.get_rank() == 0 else None


@pytest.fixture(scope="module")
def trees():
    import jax

    from streamkit_tpu.models.whisper.config import WhisperConfig as JaxWhisperConfig
    from streamkit_tpu.models.whisper.model import init_params

    jcfg = JaxWhisperConfig(**DIMS)
    return {seed: affine_random(jax.tree.map(np.asarray, init_params(jcfg, jax.random.PRNGKey(seed),
                                                                     jax.numpy.float32)), seed)
            for seed in (3, 5)}


@pytest.fixture(scope="module")
def port(trees):
    return run_ranks(_fused_scenarios, WORLD, trees, device="cpu", timeout_s=DEADLINE_S)[0]


def _jax_rows(trees, n_rows: int):
    """The JAX package's single-device run of the same two blocks."""
    import jax
    import jax.numpy as jnp

    from streamkit_tpu.engine.audio_ring import SessionAudioRing as JaxRing
    from streamkit_tpu.models.whisper.config import WhisperConfig as JaxWhisperConfig
    from streamkit_tpu.models.whisper.streaming import StreamTable as JaxTable

    ring = JaxRing(max_slots=n_rows, ring_samples=1 << 14)
    tbl = JaxTable(JaxWhisperConfig(**DIMS), jnp.float32, max_slots=n_rows, enc_t=64, dec_t=32, kv_int8=False)
    for _ in range(n_rows):
        ring.alloc()
    _run_steps(jax.tree.map(jnp.asarray, trees[3]), tbl, ring, n_rows)
    return tuple(np.asarray(x) for x in (tbl._tokens, tbl._n_tok, tbl._enc_pos))


def _assert_rows_equal(got, want):
    assert np.array_equal(got[2], want[2])  # encoder positions
    assert np.array_equal(got[1], want[1]), (got[1], want[1])  # token counts
    for r in range(len(want[1])):
        np.testing.assert_array_equal(got[0][r, : want[1][r]], want[0][r, : want[1][r]])


@pytest.mark.parametrize("tp,rows_per_shard", CASES)
def test_fused_step_sharded_matches_single_device(port, trees, tp, rows_per_shard):
    """Tokens, token counts and encoder positions of the sharded fused step
    equal the JAX single-device run and the port's one-rank run."""
    res = port[(tp, rows_per_shard)]
    n_rows = (WORLD // tp) * rows_per_shard
    dp = WORLD // tp
    # each rank holds [L, S/dp, H/tp, hd, T] and its S/dp ring rows + trash
    assert res["local_caches"] == (2, n_rows // dp, 4 // tp, 16, 64)
    assert res["local_ring"] == (n_rows // dp + 1, 1 << 14)
    _assert_rows_equal(res["mesh"], _jax_rows(trees, n_rows))
    _assert_rows_equal(res["mesh"], res["one_rank"])


def test_sharded_int8_table_executes(port):
    toks, n_tok, pos = port["int8"]["rows"]
    assert port["int8"]["local_q8"] == (2, 1, 2, 16, 64) and port["int8"]["local_scale"] == (2, 1, 2, 64)
    assert (pos == 8).all()
    assert (n_tok >= len(PREFIX)).all()


@pytest.fixture(scope="module")
def engine_runs():
    from streamkit_tpu.engine.ingest import ingest_available

    if not ingest_available():
        pytest.skip("libskit_ingest.so not built")
    return run_ranks(_engine_rank, WORLD, ("stream", "exact"), device="cpu", timeout_s=DEADLINE_S)[0]


@pytest.mark.parametrize("mode", ["stream", "exact"])
def test_serving_engine_on_mesh(engine_runs, mode):
    """SttServingEngine(mesh=...) serves a session end to end with sharded
    weights, tables and rings on 8 ranks: a final arrives, and closing the
    session leaves no stream row taken."""
    run = engine_runs[mode]
    assert "final" in run["types"], run["types"]
    assert run["idle"] and run["free_stream_rows"] == run["table_rows"] == 4
    if mode == "exact":
        assert run["finals_fallback"] > 0 and run["finals_stream"] == 0
        assert any(k.startswith("whisper_ring:") and v["calls"] for k, v in run["calls"].items())
