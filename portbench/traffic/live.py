# SPDX-License-Identifier: Apache-2.0
"""Traffic kind ``live``: concurrent live sessions into the program's
``SttServingEngine``, all opened at once, each fed its own seeded speech
through the engine's ingest pool (``IngestPool.start_replay``) in 20 ms
frames as fast as the engine takes the blocks. Serves the ``whisper``
family (``FAMILIES``).

Mix parameters (``mixes/<mix>.json``): ``sessions``, ``session_s``,
``lead_s``, ``utterance_s`` (the library's durations), ``pauses_s`` (the
cycle of pauses after each utterance), ``noise_dbfs``, ``warm_s`` (the
warm-up session's utterance and silence), ``judge_segments`` (finals whose
logits are judged), and the engine's settings ``engine`` (passed as
keyword arguments) and ``stream_steps`` (the decode steps of a fused call,
the engine's default).

The record holds every fused call (inputs, outputs, host times), every
session event and the program's counters; :func:`judge` holds the answers
against the plain reference.
"""

from __future__ import annotations

import asyncio
import os
import time
from typing import Dict, List

import numpy as np
import torch

import audio as audio_mod
import checks
from recorder import RecordingBatcher
from reference import vad as ref_vad
from reference import whisper as ref

FAMILIES = ("whisper",)

SR = 16_000
VAD_FRAME = 512
PREFIX = 4
FULL_SPEED_US = 0  # the ingest pool's frame pace: 0 feeds as fast as the engine takes blocks
REAL_TIME_US = 20_000  # the warm-up session's pace
# The engine's gather window (``SK_STREAM_GATHER_MS``). Its default, 0.8 of
# a 256 ms block, splits sessions that open together into cohorts that
# never merge once a fused call outlasts it; 1 s keeps them one batch.
GATHER_MS = 1000


def sessions_audio(mix: dict, seed: int):
    lib = audio_mod.library(seed, mix["utterance_s"])
    rng = np.random.default_rng([seed, 2])
    out = []
    for i in range(mix["sessions"]):
        out.append(audio_mod.compose(lib, rng.permutation(len(lib)), mix["pauses_s"], mix["lead_s"],
                                     mix["session_s"], mix["noise_dbfs"], np.random.default_rng([seed, 3, i])))
    # the warm-up session: the shortest utterance, then the silence that closes it
    shortest = int(np.argmin(mix["utterance_s"]))
    warm = audio_mod.compose(lib, [shortest], [mix["warm_s"]], 0.1, mix["warm_s"], mix["noise_dbfs"],
                             np.random.default_rng([seed, 4]))
    return out, warm


async def run(ctx) -> dict:
    from streamkit_tpu_torch.core.resource_manager import ResourceKey, ResourceManager
    from streamkit_tpu_torch.engine.audio_ring import RING_SAMPLES
    from streamkit_tpu_torch.engine.stt_serving import SttServingEngine
    from streamkit_tpu_torch.models.whisper.config import language_index
    from streamkit_tpu_torch.models.whisper.tokenizer import WhisperDetokenizer

    mix = ctx.mix
    eng_kw = dict(mix["engine"])
    sessions, warm = sessions_audio(mix, ctx.seed)
    block = eng_kw["vad_block_frames"] * VAD_FRAME
    blocks_per_session = len(sessions[0]) // block + 1
    rm = ResourceManager()
    key = ResourceKey.from_params("whisper", {"path": None, "size": ctx.port_size, "dtype": str(torch.bfloat16),
                                              "device": str(ctx.device)})

    async def loader():
        return ctx.port_cfg, ctx.params, WhisperDetokenizer()

    await rm.get_or_create(key, loader)
    os.environ["SK_STREAM_GATHER_MS"] = str(GATHER_MS)  # read when the engine starts
    batcher = RecordingBatcher(tick_ms=5.0, device=ctx.device)
    eng = SttServingEngine(model_size=ctx.port_size, dtype="bfloat16", max_sessions=mix["sessions"],
                           batcher=batcher, resources=rm, device=ctx.device,
                           ingest_queue_cap=max(4096, mix["sessions"] * (blocks_per_session + 8)), **eng_kw)
    await eng.start()
    ctx.mark("engine started")
    lang = np.int32(language_index(eng_kw.get("language", "en")))

    # -- warm-up: one session to its first final, then each exact-final kind
    first_final = asyncio.get_running_loop().create_future()

    def warm_event(ev):
        if ev["type"] == "final" and not first_final.done():
            first_final.set_result(ev)

    sid = eng.open_session(warm_event)
    eng.start_replay(sid, audio_mod.as_float(warm), frame_us=REAL_TIME_US)
    await asyncio.wait_for(first_final, timeout=ctx.warm_timeout)
    ctx.mark("warm session's final")
    eng.close_session(sid)
    for name in sorted(batcher.registered_kinds()):
        if name.startswith("whisper_ring:"):
            await batcher.submit(name, np.int32(0), np.int32(0), np.int32(min(int(name.rsplit(":", 1)[1]), SR)), lang)
    while not eng.idle():
        await asyncio.sleep(0.01)
    ctx.mark("warm-up done")

    # -- the measured window
    events: List[tuple] = []
    c0 = batcher.counters("stream_step")
    t_w = ctx.window_start()
    for i, pcm in enumerate(sessions):
        sid = eng.open_session(lambda ev, i=i: events.append((i, time.monotonic(), ev)))
        eng.start_replay(sid, audio_mod.as_float(pcm), frame_us=FULL_SPEED_US)
    await ctx.measure(batcher)
    t_end = ctx.window_end()
    c1 = ctx.snap_host.get("stream_step", c0)
    t_host = ctx.t_host
    dropped = eng.pool.dropped()
    enc_t = eng._tbl.enc_t  # the stream table's encoder columns: K4's T
    await eng.stop()
    batcher.stop()
    calls = sorted(batcher.calls_of("stream_step"), key=lambda c: c.t1)
    m = ctx.dims
    tl = timeline(calls, min(mix["sessions"], 64), mix["stream_steps"])
    add_flops(tl, m)
    rows_in = [(c.t0, c.t1, c.inputs[0].shape[0] * block / SR) for c in calls if c.error is None]
    from stats import windowed_work

    live = {
        "host_audio_s": windowed_work(rows_in, t_w, t_host),
        "calls": c1[0] - c0[0], "items": c1[1] - c0[1], "dispatch_s": c1[2] - c0[2],
        "dropped": dropped,
        "attempted": sum(c.batch for c in calls if t_w <= c.t1 <= t_end) + dropped,
        "failed": sum(c.batch for c in calls if c.error is not None and t_w <= c.t1 <= t_end) + dropped,
    }
    win = [c for c in calls if t_w <= c.t0 and c.t1 <= t_end]
    n_calls = max(1, len(win))
    ctx.log(f"# fused calls in the window {len(win)}, rows a call {sum(c.batch for c in win) / n_calls:.2f} "
            f"(first {[c.inputs[0].shape[0] for c in win[:8]]}), host ms a call "
            f"{1000 * sum(c.t1 - c.t0 for c in win) / n_calls:.1f} (by thirds "
            f"{[round(1000 * sum(c.t1 - c.t0 for c in p) / max(1, len(p)), 1) for p in _thirds(win)]}); finals from "
            f"the stream table {eng.finals_stream}, exact {eng.finals_fallback}; dropped {dropped}; audio-s/s "
            f"{live['host_audio_s'] / max(1e-9, t_host - t_w):.3f} over the first {t_host - t_w:.1f} s")
    return {"kind": "live", "live": live, "t_w": t_w, "t_end": t_end, "calls": calls, "timeline": tl,
            "events": events, "sessions": sessions, "warm": warm, "ring_samples": RING_SAMPLES, "block": block,
            "n_chunks": max(2, -(-block // ref.CHUNK_SAMPLES)), "dims": m, "enc_t": enc_t}


def _thirds(xs: list) -> list:
    k = len(xs) // 3
    return [xs[:k], xs[k : 2 * k], xs[2 * k :]]


# ---------------------------------------------------------------------------
# the fused calls, row by row
# ---------------------------------------------------------------------------
def timeline(calls, n_slots: int, max_steps: int) -> dict:
    """Follow every table slot through the fused calls (in completion
    order): per row its encoder positions before and after, its tokens
    before and after, which decoder columns it fed and at which encoder
    horizon, and what each call's kernels were given. Rows whose outputs
    contradict the step's rules count in ``bad``."""
    state: Dict[int, dict] = {}
    slot_pos = [0] * n_slots
    out, bad = [], 0
    for c in calls:
        if c.error is not None or c.outputs[0] is None:
            out.append({"rows": [], "pos_all": list(slot_pos), "flops": 0, "fold": [0] * n_slots,
                        "commit": [0] * n_slots})
            continue
        meta = c.inputs[0]
        probs, toks, ntk, pos_new = c.outputs
        dec_t = toks.shape[1]
        rows, fold, commit = [], [0] * n_slots, [0] * n_slots
        pos_all = list(slot_pos)
        for r in range(meta.shape[0]):
            slot, stream, wpos, cstart, n_req, do_dec, do_reset = (int(x) for x in meta[r, :7])
            st = state.setdefault(stream, {"n": 0, "fed": 0})  # a fresh table holds zeros
            if do_reset:
                st["n"], st["fed"] = PREFIX, 0
                slot_pos[stream] = 0
            pos0 = slot_pos[stream]
            pos_all[stream] = pos0
            pos1 = int(pos_new[r])
            if pos1 != pos0 + 8 * n_req:
                bad += 1
            n0, n1 = st["n"], int(ntk[r])
            fed, steps = [], 0
            if do_dec:
                fed, st["fed"], ok, steps = _decode_steps(st["fed"], n0, n1, pos1, max_steps, dec_t)
                bad += 0 if ok else 1
            elif n1 != n0:
                bad += 1
            st["n"] = n1
            slot_pos[stream] = pos1
            fold[stream], commit[stream] = steps, 8 * n_req
            rows.append({"slot": slot, "stream": stream, "wpos": wpos, "cstart": cstart, "n_req": n_req,
                         "do_dec": do_dec, "do_reset": do_reset, "pos0": pos0, "pos1": pos1, "n0": n0, "n1": n1,
                         "fed": fed, "probs": probs[r], "tokens": toks[r], "t1": c.t1})
        out.append({"rows": rows, "pos_all": pos_all, "fold": fold, "commit": commit, "dec_t": dec_t})
    return {"calls": out, "bad": bad}


def _decode_steps(fed: int, n0: int, n1: int, ep: int, max_steps: int, dec_t: int):
    """The continuation decoder's steps of one row: ``(fed columns as
    (column, horizon), fed after, consistent, active steps)``."""
    feed0 = max(min(fed, n0 - 1), 0)
    n, appended, want = n0, 0, n1 - n0
    done = False
    cols, steps = [], 0
    for i in range(max_steps):
        if done or n <= 0 or ep <= 0:
            done = True
            continue
        steps += 1
        col = min(feed0 + i, dec_t - 1)
        cols.append((col, ep))
        fed = col + 1
        if fed == n:
            if appended < want and n < dec_t - 1:
                n += 1
                appended += 1
            else:
                done = True
    return cols, fed, appended == want, steps


def add_flops(tl: dict, m: dict) -> None:
    """Each call's useful model operations (:mod:`roofline.whisper`)."""
    from roofline import whisper as wr

    for call in tl["calls"]:
        call["flops"] = wr.stream_call(m, [(r["pos0"], 8 * r["n_req"], r["fed"]) for r in call["rows"]])


def trace_readings(ctx, rec: dict, trace) -> dict:
    """In the fused calls that lie wholly in the trace: the device time, the
    audio and the useful operations of the whole step, and K2's, K3's and
    K4's least time and device time."""
    from roofline import k2, k3, k4, least_seconds

    m, peak = rec["dims"], ctx.peaks
    by_seq = {c.seq: tl for c, tl in zip(rec["calls"], rec["timeline"]["calls"])}
    spans = [s for s in trace.whole_spans("stream_step") if s.seq in by_seq and by_seq[s.seq]["rows"]]
    he, hde = m["enc_heads"], m["d"] // m["enc_heads"]
    ht, hdt = m["dec_heads"], m["d"] // m["dec_heads"]
    le, ld = m["enc_layers"], m["dec_layers"]
    c = ref.CHUNK_POS * rec["n_chunks"]
    enc_pairs = [(le, he * hde, 1, c)] * 2 + [(le, he, 4, c)] * 2 + [(ld, ht * hdt, 1, c)] * 2 + [(ld, ht, 4, c)] * 2
    steps = ctx.mix["stream_steps"]
    fold_pairs = [(ld, ht * hdt, 2, steps)] * 2
    k2_least = k3_least = k4_least = 0.0
    step = {"device_s": 0.0, "audio_s": 0.0, "flops": 0, "calls": len(spans)}
    for s in spans:
        tl = by_seq[s.seq]
        step["device_s"] += trace.busy_within(s)
        step["audio_s"] += len(tl["rows"]) * rec["block"] / SR
        step["flops"] += tl["flops"]
        pos = tl["pos_all"]
        k3_least += le * least_seconds(k3.flops(he, c, hde, pos), k3.nbytes(he, c, hde, pos), peak)
        k2_least += least_seconds(0, k2.nbytes(enc_pairs, tl["commit"]), peak)
        k2_least += least_seconds(0, k2.nbytes(fold_pairs, tl["fold"]), peak)
        # K4 runs every decode step over every row of the call, at the row's
        # horizon after this call's encode
        eps = [r["pos1"] for r in tl["rows"]]
        k4_least += ld * steps * least_seconds(k4.flops(ht, hdt, eps, rec["enc_t"]),
                                               k4.nbytes(ht, hdt, eps, rec["enc_t"]), peak, "f32_flops")
    return {"step": step,
            "k2": {"least_s": k2_least, "device_s": trace.kernel_seconds(k2.KERNEL, spans), "calls": len(spans),
                   "launches": trace.kernel_count(k2.KERNEL, spans)},
            "k3": {"least_s": k3_least, "device_s": trace.kernel_seconds(k3.KERNEL, spans), "calls": len(spans),
                   "launches": trace.kernel_count(k3.KERNEL, spans)},
            "k4": {"least_s": k4_least, "device_s": trace.kernel_seconds(k4.KERNEL, spans), "calls": len(spans),
                   "launches": trace.kernel_count(k4.KERNEL, spans)}}


# ---------------------------------------------------------------------------
# judging
# ---------------------------------------------------------------------------
def _sessions_rows(rec: dict):
    """Window sessions' rows in order, found by their first block's bytes
    (each session's noise floor is its own)."""
    first = {audio_mod.as_float(pcm)[: rec["block"]].tobytes(): i for i, pcm in enumerate(rec["sessions"])}
    by_stream: Dict[int, list] = {}
    for c, call in zip(rec["calls"], rec["timeline"]["calls"]):
        if c.t0 < rec["t_w"] or c.error is not None:
            continue
        frames = c.inputs[1]
        for r, row in enumerate(call["rows"]):
            by_stream.setdefault(row["stream"], []).append((row, frames[r]))
    out = {}
    for stream, rows in by_stream.items():
        key = np.asarray(rows[0][1], np.float32).reshape(-1).tobytes()
        if key in first:
            for k, (r, _) in enumerate(rows):
                r["ordinal"] = k
            out[first[key]] = [r for r, _ in rows]
    return out


def _ring_before(rec: dict) -> Dict[int, np.ndarray]:
    """Each ring slot's contents when the window opened: the warm-up
    session's blocks where it wrote them, zeros elsewhere."""
    rings: Dict[int, np.ndarray] = {}
    warm, block, rs = rec["warm"], rec["block"], rec["ring_samples"]
    k = 0
    for c, call in zip(rec["calls"], rec["timeline"]["calls"]):
        if c.t0 >= rec["t_w"]:
            break
        for row in call["rows"]:
            ring = rings.setdefault(row["slot"], np.zeros(rs, np.int16))
            piece = warm[k * block : (k + 1) * block]
            if piece.size == block:
                ring[row["wpos"] : row["wpos"] + block] = piece
            k += 1
    return rings


def _gather(pcm: np.ndarray, stale: np.ndarray, written: int, lo: int, hi: int, rs: int) -> np.ndarray:
    """Ring contents of the session's absolute samples ``[lo, hi)`` after it
    wrote ``written`` samples; positions not yet written hold what the slot
    held before (its own samples one ring back, or the earlier occupant's)."""
    idx = np.arange(lo, hi)
    out = stale[idx % rs].copy()
    back = idx - rs
    own_old = (idx >= written) & (back >= 0)
    out[own_old] = pcm[back[own_old]]
    fresh = (idx >= 0) & (idx < written)
    out[fresh] = pcm[idx[fresh]]
    return out


def judge(ctx, rec: dict, precisions=("f32",)) -> dict:
    """The numbers the cell compares (see the cell's ``limits``); with more
    ``precisions``, the control's readings under the same names."""
    dev = ctx.device
    mix, m = ctx.mix, rec["dims"]
    rs, block = rec["ring_samples"], rec["block"]
    rows_of = _sessions_rows(rec)
    found = len(rows_of)
    sched = rec["timeline"]["bad"] + (len(rec["sessions"]) - found)
    # block order and ring positions
    for i, rows in rows_of.items():
        for k, row in enumerate(rows):
            sched += int(row["wpos"] != (k * block) % rs)
    # VAD: every frame the window's calls scored
    n_frames = {i: len(rows) * block // VAD_FRAME for i, rows in rows_of.items()}
    longest = max(n_frames.values(), default=0)
    ids = sorted(rows_of)
    pcm = torch.from_numpy(np.stack([audio_mod.as_float(rec["sessions"][i][: longest * VAD_FRAME]) for i in ids]))
    readings = {f"vad_{p}": 0.0 for p in precisions}
    prog_probs = {i: np.concatenate([r["probs"] for r in rows_of[i]]) for i in ids}
    ref_probs = {}
    if ids:
        base = ref_vad.frame_probs(pcm.to(dev), "f32").cpu().numpy()
        ref_probs = {i: base[j][: n_frames[i]] for j, i in enumerate(ids)}
        readings["vad_f32"] = max(float(np.abs(prog_probs[i] - ref_probs[i]).max()) for i in ids)
        if "fp8" in precisions:
            low = ref_vad.frame_probs(pcm.to(dev), "fp8").cpu().numpy()
            readings["vad_fp8"] = max(float(np.abs(low[j][: n_frames[i]] - ref_probs[i]).max())
                                      for j, i in enumerate(ids))
    # segments: the plain segmenter over the reference's own probabilities,
    # against the finals the program emitted. A frame whose reference
    # probability lies within the VAD's limit of the threshold may fall on
    # either side; there it takes the side the program's probability took.
    eng = mix["engine"]
    threshold = eng.get("vad_threshold", 0.5)
    tolerance = ctx.workload["limits"]["vad_f32"]
    horizon_s = ((512 // ref.CHUNK_POS) - 8) * ref.CHUNK_SAMPLES / SR  # the stream table's 512 positions
    max_seg = min(eng.get("max_segment_secs", 30.0), horizon_s) if eng.get("final_mode") == "stream" else \
        eng.get("max_segment_secs", 30.0)
    finals: Dict[int, list] = {}
    for i, t, ev in rec["events"]:
        if ev["type"] == "final":
            finals.setdefault(i, []).append((ev["start_ms"] * SR // 1000 // VAD_FRAME,
                                             ev["end_ms"] * SR // 1000 // VAD_FRAME, ev["text"], t))
    seg_bad, text_bad, cands, near = 0, 0, [], 0
    margin = 1.0
    for i in ids:
        rows = rows_of[i]
        either = np.abs(ref_probs[i] - threshold) <= tolerance
        near += int(either.sum())
        speech = np.where(either, prog_probs[i] >= threshold, ref_probs[i] >= threshold)
        segs = ref_vad.segments(speech.astype(np.float64), 0.5, eng.get("min_silence_ms", 700.0), max_seg)
        got = {(s, e): (text, t) for s, e, text, t in finals.get(i, [])}
        for s, e in segs:
            close_row = rows[(e - 1) * VAD_FRAME // block]
            if close_row["t1"] > rec["t_end"] - margin:
                continue
            if (s, e) not in got:
                seg_bad += 1
                continue
            cands.append((i, s, e, got[(s, e)][0]))
        ref_set = set(segs)
        seg_bad += sum(1 for s, e, _, t in finals.get(i, []) if t <= rec["t_end"] and (s, e) not in ref_set)
    # which finals came from the stream table; their texts
    judged = []
    for i, s, e, text in cands:
        info = _segment_rows(rows_of[i], s, e, block)
        try:
            toks = checks.parse_tokens(text)
        except ValueError:
            text_bad += 1
            continue
        if info is None:
            text_bad += 1
            continue
        if info["stream"]:
            last = info["last_dec"]
            if toks != [int(x) for x in last["tokens"][PREFIX : last["n1"]]]:
                text_bad += 1
                continue
        judged.append((i, s, e, toks, info))
    # the logits of a sample of finals, the most tokens among them
    rng = np.random.default_rng([ctx.seed, 9])
    k = min(mix["judge_segments"], len(judged))
    pick = []
    if judged:
        longest_i = max(range(len(judged)), key=lambda j: len(judged[j][3]))
        rest = [j for j in range(len(judged)) if j != longest_i]
        pick = [longest_i] + list(rng.choice(rest, size=min(k - 1, len(rest)), replace=False)) if k else []
    ws = {p: ref.Weights(ctx.tree, p) for p in precisions}
    ctx.drop_program()
    rings = _ring_before(rec)
    parts = []
    for j in pick:
        i, s, e, toks, info = judged[int(j)]
        if info["stream"]:
            parts.append(_stream_gaps(ws, rec, rec["sessions"][i], rings, info, m, dev))
        else:
            parts.append(_fallback_gaps(ws, rec, rec["sessions"][i], s, e, toks, eng, m, dev))
    gap = checks.max_readings(parts)
    for p in precisions:
        readings[f"logit_gap_{p}"] = gap.get(p, 0.0)
    readings.update(segment_mismatches=seg_bad, text_mismatches=text_bad, schedule_mismatches=sched,
                    finals_judged=len(pick), finals_closed=len(cands), vad_frames_near_threshold=near)
    return readings


def _segment_rows(rows: list, s: int, e: int, block: int):
    """The rows of the segment ``[s, e)`` frames: from its reset to the row
    that closed it; whether its final came from the stream table, and the
    last row that decoded."""
    per = block // VAD_FRAME
    start_row, close_row = s // per, (e - 1) // per
    seg_rows = [r for r in rows[start_row : close_row + 1]]
    reset = [j for j, r in enumerate(seg_rows) if r["do_reset"]]
    if not reset:
        return {"stream": False, "rows": []}
    seg_rows = seg_rows[reset[0] :]
    decs = [r for r in seg_rows if r["do_dec"]]
    tip = s * VAD_FRAME + ref.CHUNK_SAMPLES * sum(r["n_req"] for r in seg_rows)
    last = decs[-1] if decs else None
    stream = last is not None and last["n1"] > PREFIX and tip >= e * VAD_FRAME - 2 * ref.CHUNK_SAMPLES
    return {"stream": stream, "rows": seg_rows, "last_dec": last, "start": s * VAD_FRAME}


def _stream_gaps(ws, rec, pcm, rings, info, m, dev) -> dict:
    """A stream-table final: the chunk-causal encoder call by call as the
    rows committed it, then the continuation decoder with each column's
    horizon, over the served tokens."""
    rs, block, n_chunks = rec["ring_samples"], rec["block"], rec["n_chunks"]
    last = info["last_dec"]
    rows = info["rows"][: info["rows"].index(last) + 1]
    stale = rings.get(rows[0]["slot"], np.zeros(rs, np.int16))
    horizon: Dict[int, int] = {}
    for r in rows:
        for col, ep in r["fed"]:
            horizon[col] = ep
    tokens = [int(t) for t in last["tokens"][: last["n1"]]]
    targets = tokens[PREFIX:]
    out = {}
    for p, w in ws.items():
        enc = ref.StreamEncoder(w, m["enc_heads"], m["n_audio_ctx"])
        tip = info["start"]
        for r in rows:
            if r["n_req"]:
                lo = tip - ref.LEFT_CTX
                hi = tip + n_chunks * ref.CHUNK_SAMPLES + ref.RIGHT_CTX
                g = _gather(pcm, stale, (r["ordinal"] + 1) * block, lo, hi, rs)
                enc.call(torch.from_numpy(g.astype(np.float32) / 32768.0).to(dev), n_chunks, r["n_req"])
                tip += ref.CHUNK_SAMPLES * r["n_req"]
        out[p] = enc.states()
    t = len(tokens) - 1
    hz = torch.tensor([[horizon.get(j, max(horizon.values(), default=1)) for j in range(t)]], device=dev)
    tok_t = torch.tensor([tokens[:t]], device=dev)
    cache = {}

    def logits_of(w):
        key = id(w)
        if key not in cache:
            xk, xv = ref.cross_kv(w, out[w.precision])
            cache[key] = ref.decode_logits(w, tok_t, xk, xv, m["dec_heads"], hz)[0, PREFIX - 1 :]
        return cache[key]

    tg = torch.tensor(targets, device=dev)
    bias = torch.zeros((len(targets), m["n_vocab"]), device=dev)
    return checks.read_positions(ws, logits_of, tg, bias)


def _fallback_gaps(ws, rec, pcm, s, e, toks, eng, m, dev) -> dict:
    """An exact final (the stream table could not serve it): the engine's
    bucketed full-window decode."""
    buckets = sorted(eng.get("window_buckets") or [4.0, 8.0, 30.0])
    n = min((e - s) * VAD_FRAME, int(buckets[-1] * SR))
    b = next((x for x in buckets if n <= int(x * SR)), buckets[-1])
    budget = min(eng.get("max_tokens", 32), max(12, int(b * 4) + 8))
    # the greedy loop stops once it has written one token past the row's cap
    cap = min(max(1, min(n // 4000 + 4, budget)) + 1, budget)
    eot = m["n_vocab"] - 51865 + 50256
    seg = {"audio": pcm[s * VAD_FRAME : s * VAD_FRAME + n], "window": int(b * SR),
           "prefix": [eot + 1, eot + 2, _transcribe(m), _transcribe(m) + 3], "tokens": toks, "cap": cap,
           "eot": eot, "suppress_first": []}
    return checks.full_window_gaps(ws, seg, m["enc_heads"], m["n_mels"], dev)


def _transcribe(m: dict) -> int:
    """``<|transcribe|>`` of the vocabulary (openai/whisper's special-token
    layout; large-v3 adds one language)."""
    eot = m["n_vocab"] - 51865 + 50256
    sot = eot + 1
    return sot + 100 + 1 + 58 + 1 if m["n_vocab"] == 51866 else sot + 100 + 58 + 1


def counts(rec: dict):
    return rec["live"]["attempted"], rec["live"]["failed"]


def counts_detail(rec: dict) -> dict:
    live = rec["live"]
    return {"fused_calls": live["calls"], "rows": live["items"],
            "partials": sum(1 for _, _, ev in rec["events"] if ev["type"] == "partial"),
            "finals": sum(1 for _, _, ev in rec["events"] if ev["type"] == "final"), "dropped": live["dropped"]}
