// SPDX-License-Identifier: Apache-2.0
// Session audio ingestion shim: moves per-packet pacing, buffering, and
// VAD-block assembly off the Python serving loop.
//
// A copy of native/shims/ingest.cpp for the PyTorch port, built with g++ at
// first use (streamkit_tpu_torch/ops/_build.py). One change: skingest_push
// refuses a session whose paced replay (PCM or Opus) is running (-1): the
// replay assembles into a thread-local accumulator, so a concurrent push
// would queue its samples ahead of earlier replayed ones.
//
// Why: the dynamic engine's streaming STT path needs ONE fused device call
// per VAD block (256 ms) per session — but audio arrives as 20 ms packets,
// and a single-core Python host measurably cannot pace 64 sessions x 50
// packets/s through asyncio (round-2 PERF_NOTES: 16 paced sessions collapse
// to p50 8.5 s on ingestion alone). The reference pays the same cost in
// tokio tasks + bounded channels (crates/engine/src/dynamic_pin_distributor.rs,
// crates/nodes/src/audio/codecs/opus.rs:102-140 blocking handoff); natively
// threaded, that is cheap — in Python it is the bottleneck.
//
// This shim owns:
//   * per-session sample accumulators (float32 PCM in, any granularity),
//   * block assembly: every `block_samples` completed samples become one
//     queue entry stamped with the arrival time of the sample completing it,
//   * optional paced replay: a C++ thread feeds a session's preloaded audio
//     at exact frame cadence (the loadtest/bench ingress; real transports
//     push from their receive callbacks instead),
//   * a drain API returning ALL completed blocks as one coalesced batch
//     (ids + arrival stamps + a contiguous [n, block_samples] buffer) — one
//     ctypes call per engine tick, independent of session count.
//
// Python binding: streamkit_tpu_torch/engine/ingest.py (ctypes).

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <dlfcn.h>
#include <mutex>
#include <thread>
#include <vector>

namespace {

using Clock = std::chrono::steady_clock;

// -- libopus (dlopen, no headers needed) -------------------------------------
typedef void* (*opus_create_fn)(int32_t, int, int*);
typedef int (*opus_decode_float_fn)(void*, const unsigned char*, int32_t, float*, int, int);
typedef void (*opus_destroy_fn)(void*);

struct OpusApi {
    opus_create_fn create = nullptr;
    opus_decode_float_fn decode_float = nullptr;
    opus_destroy_fn destroy = nullptr;
    bool ok = false;
};

OpusApi& opus_api() {
    static OpusApi api = [] {
        OpusApi a;
        void* h = dlopen("libopus.so.0", RTLD_NOW | RTLD_GLOBAL);
        if (!h) h = dlopen("libopus.so", RTLD_NOW | RTLD_GLOBAL);
        if (h) {
            a.create = reinterpret_cast<opus_create_fn>(dlsym(h, "opus_decoder_create"));
            a.decode_float =
                reinterpret_cast<opus_decode_float_fn>(dlsym(h, "opus_decode_float"));
            a.destroy = reinterpret_cast<opus_destroy_fn>(dlsym(h, "opus_decoder_destroy"));
            a.ok = a.create && a.decode_float && a.destroy;
        }
        return a;
    }();
    return api;
}

int64_t now_ns() {
    return std::chrono::duration_cast<std::chrono::nanoseconds>(
               Clock::now().time_since_epoch())
        .count();
}

struct Block {
    int32_t sid;
    int64_t arrival_ns;  // arrival of the push that completed the block
    std::vector<float> samples;
};

struct Session {
    bool open = false;
    std::vector<float> acc;  // partial block accumulator
    // paced replay
    std::thread replay;
    std::atomic<bool> replay_stop{false};
    bool replaying = false;  // a replay thread owns the accumulator
    bool close_at_end = false;
    int64_t replay_start_ns = 0;
    std::vector<float> replay_audio;
    // opus replay: pre-encoded packets (concatenated bytes + offsets)
    std::vector<unsigned char> replay_pkts;
    std::vector<int32_t> replay_offs;
};

struct Pool {
    int block_samples;
    size_t queue_cap;
    std::vector<Session> sessions;
    std::deque<Block> queue;
    std::mutex mu;                // guards sessions[i].acc/open/replaying + queue
    std::condition_variable cv;   // signalled on new blocks
    std::atomic<int64_t> dropped_blocks{0};

    Pool(int max_sessions, int block, size_t cap)
        : block_samples(block), queue_cap(cap), sessions(max_sessions) {}
};

// Move full blocks out of a session-locally assembled accumulator into the
// shared queue — the global mutex is taken once per ~half-second block, not
// once per 20 ms frame. At full-speed replay (throughput benches) the
// per-frame locking was measurable: 128 session threads × 50 locks per
// audio-second against ONE mutex put the ingest ceiling at ~337× realtime
// on a single-core host; block-granular locking cuts the traffic ~26×.
// Returns true when at least one block was queued (caller notifies cv).
bool emit_blocks(Pool* p, int sid, std::vector<float>& acc, int64_t t_ns) {
    if (acc.size() < size_t(p->block_samples)) return false;
    std::lock_guard<std::mutex> g(p->mu);
    Session& s = p->sessions[sid];
    if (!s.open) {
        acc.clear();
        return false;
    }
    size_t off = 0;
    bool queued = false;
    while (acc.size() - off >= size_t(p->block_samples)) {
        Block b;
        b.sid = sid;
        b.arrival_ns = t_ns;
        b.samples.assign(acc.begin() + off, acc.begin() + off + p->block_samples);
        off += p->block_samples;
        if (p->queue.size() >= p->queue_cap) {
            p->queue.pop_front();
            p->dropped_blocks.fetch_add(1, std::memory_order_relaxed);
        }
        p->queue.push_back(std::move(b));
        queued = true;
    }
    acc.erase(acc.begin(), acc.begin() + off);
    return queued;
}

void push_locked(Pool* p, int sid, const float* pcm, int64_t n, int64_t t_ns) {
    Session& s = p->sessions[sid];
    if (!s.open) return;
    s.acc.insert(s.acc.end(), pcm, pcm + n);
    while (s.acc.size() >= size_t(p->block_samples)) {
        Block b;
        b.sid = sid;
        b.arrival_ns = t_ns;
        b.samples.assign(s.acc.begin(), s.acc.begin() + p->block_samples);
        s.acc.erase(s.acc.begin(), s.acc.begin() + p->block_samples);
        if (p->queue.size() >= p->queue_cap) {
            // backpressure: drop-oldest (the reference's BestEffort edge
            // semantics, dynamic_pin_distributor.rs drop-old accounting)
            p->queue.pop_front();
            p->dropped_blocks.fetch_add(1, std::memory_order_relaxed);
        }
        p->queue.push_back(std::move(b));
    }
}

void replay_thread(Pool* p, int sid, int frame_samples, int64_t frame_us,
                   int64_t start_delay_us) {
    Session& s = p->sessions[sid];
    auto start = Clock::now() + std::chrono::microseconds(start_delay_us);
    {
        std::lock_guard<std::mutex> g(p->mu);
        s.replay_start_ns = std::chrono::duration_cast<std::chrono::nanoseconds>(
                                start.time_since_epoch())
                                .count();
    }
    const std::vector<float>& audio = s.replay_audio;
    int64_t n_frames = int64_t(audio.size()) / frame_samples;
    // session-local block assembly (see emit_blocks)
    std::vector<float> acc;
    acc.reserve(size_t(p->block_samples) + size_t(frame_samples));
    {
        std::lock_guard<std::mutex> g(p->mu);
        acc.swap(s.acc);
    }
    for (int64_t i = 0; i < n_frames; i++) {
        std::this_thread::sleep_until(start + std::chrono::microseconds(i * frame_us));
        if (s.replay_stop.load(std::memory_order_relaxed)) break;
        const float* f = audio.data() + i * frame_samples;
        acc.insert(acc.end(), f, f + frame_samples);
        if (emit_blocks(p, sid, acc, now_ns())) p->cv.notify_all();
    }
    {
        std::lock_guard<std::mutex> g(p->mu);
        s.acc.insert(s.acc.end(), acc.begin(), acc.end());
        s.replaying = false;
        if (s.close_at_end) s.open = false;
    }
}

// Opus replay: decode pre-encoded packets natively (libopus decodes any
// Opus stream straight to the pool's sample rate / channel count — the
// fused native 16 kHz decode the YAML compiler's decode→resample pass
// emits) and push the PCM at packet cadence. frame_us = 0 replays at full
// speed (throughput benches); 20_000 is the realtime Opus cadence. The
// whole ingress chain (pacing, decode, block assembly) runs on this C++
// thread: Python only drains coalesced blocks.
void replay_opus_thread(Pool* p, int sid, int sample_rate, int channels,
                        int64_t frame_us, int64_t start_delay_us) {
    Session& s = p->sessions[sid];
    auto start = Clock::now() + std::chrono::microseconds(start_delay_us);
    {
        std::lock_guard<std::mutex> g(p->mu);
        s.replay_start_ns = std::chrono::duration_cast<std::chrono::nanoseconds>(
                                start.time_since_epoch())
                                .count();
    }
    OpusApi& api = opus_api();
    int err = 0;
    void* dec = api.create(sample_rate, channels, &err);
    const int max_frame = sample_rate * 120 / 1000;  // 120 ms max opus frame
    std::vector<float> pcm(size_t(max_frame) * channels);
    // session-local block assembly (see emit_blocks)
    std::vector<float> acc;
    acc.reserve(size_t(p->block_samples) + size_t(max_frame) * channels);
    {
        std::lock_guard<std::mutex> g(p->mu);
        acc.swap(s.acc);
    }
    int64_t n_pkts = (dec && err == 0) ? int64_t(s.replay_offs.size()) - 1 : 0;
    for (int64_t i = 0; i < n_pkts; i++) {
        if (frame_us > 0)
            std::this_thread::sleep_until(start +
                                          std::chrono::microseconds(i * frame_us));
        if (s.replay_stop.load(std::memory_order_relaxed)) break;
        const unsigned char* pkt = s.replay_pkts.data() + s.replay_offs[i];
        const int32_t len = s.replay_offs[i + 1] - s.replay_offs[i];
        const int n = api.decode_float(dec, pkt, len, pcm.data(), max_frame, 0);
        if (n <= 0) continue;
        acc.insert(acc.end(), pcm.data(), pcm.data() + size_t(n) * channels);
        if (emit_blocks(p, sid, acc, now_ns())) p->cv.notify_all();
    }
    if (dec) api.destroy(dec);
    {
        std::lock_guard<std::mutex> g(p->mu);
        s.acc.insert(s.acc.end(), acc.begin(), acc.end());
        s.replaying = false;
        if (s.close_at_end) s.open = false;
    }
}

}  // namespace

extern "C" {

void* skingest_create(int max_sessions, int block_samples, int queue_cap) {
    if (max_sessions <= 0 || block_samples <= 0 || queue_cap <= 0) return nullptr;
    return new Pool(max_sessions, block_samples, size_t(queue_cap));
}

void skingest_destroy(void* pool) {
    auto* p = static_cast<Pool*>(pool);
    if (!p) return;
    for (auto& s : p->sessions) {
        s.replay_stop.store(true);
        if (s.replay.joinable()) s.replay.join();
    }
    delete p;
}

// open the lowest free session slot; -1 when full
int skingest_open(void* pool) {
    auto* p = static_cast<Pool*>(pool);
    std::lock_guard<std::mutex> g(p->mu);
    for (size_t i = 0; i < p->sessions.size(); i++) {
        if (!p->sessions[i].open && !p->sessions[i].replay.joinable()) {
            p->sessions[i].open = true;
            p->sessions[i].acc.clear();
            return int(i);
        }
    }
    return -1;
}

void skingest_close(void* pool, int sid) {
    auto* p = static_cast<Pool*>(pool);
    if (sid < 0 || size_t(sid) >= p->sessions.size()) return;
    Session& s = p->sessions[sid];
    s.replay_stop.store(true);
    if (s.replay.joinable()) s.replay.join();
    std::lock_guard<std::mutex> g(p->mu);
    s.open = false;
    s.acc.clear();
    s.replay_audio.clear();
    s.replay_pkts.clear();
    s.replay_offs.clear();
    s.replay_stop.store(false);
}

// append PCM from any thread (transport receive callbacks); -1 when the
// session is closed or a paced replay is feeding it
int skingest_push(void* pool, int sid, const float* pcm, long long n) {
    auto* p = static_cast<Pool*>(pool);
    if (sid < 0 || size_t(sid) >= p->sessions.size() || n < 0) return -1;
    bool notify = false;
    {
        std::lock_guard<std::mutex> g(p->mu);
        if (!p->sessions[sid].open || p->sessions[sid].replaying) return -1;
        size_t before = p->queue.size();
        push_locked(p, sid, pcm, n, now_ns());
        notify = p->queue.size() != before;
    }
    if (notify) p->cv.notify_all();
    return 0;
}

// start a paced replay: audio is copied; a dedicated thread pushes
// `frame_samples` every `frame_us` starting `start_delay_us` from now.
// close_at_end marks the session closed after the last frame.
int skingest_start_replay(void* pool, int sid, const float* audio, long long n,
                          int frame_samples, long long frame_us,
                          long long start_delay_us, int close_at_end) {
    auto* p = static_cast<Pool*>(pool);
    if (sid < 0 || size_t(sid) >= p->sessions.size()) return -1;
    Session& s = p->sessions[sid];
    {
        std::lock_guard<std::mutex> g(p->mu);
        if (!s.open || s.replay.joinable()) return -1;
        s.replay_audio.assign(audio, audio + n);
        s.close_at_end = close_at_end != 0;
        s.replay_stop.store(false);
        s.replaying = true;
    }
    s.replay = std::thread(replay_thread, p, sid, frame_samples, frame_us,
                           start_delay_us);
    return 0;
}

// start an Opus-packet replay: packets (concatenated bytes + offsets[n+1])
// are copied; a dedicated thread decodes each natively at `sample_rate`/
// `channels` and pushes the PCM every `frame_us` (0 = full speed). Returns
// -2 when libopus is unavailable.
int skingest_start_replay_opus(void* pool, int sid, const unsigned char* data,
                               const int32_t* offsets, int n_packets,
                               int sample_rate, int channels,
                               long long frame_us, long long start_delay_us,
                               int close_at_end) {
    auto* p = static_cast<Pool*>(pool);
    if (sid < 0 || size_t(sid) >= p->sessions.size() || n_packets < 0) return -1;
    if (!opus_api().ok) return -2;
    Session& s = p->sessions[sid];
    {
        std::lock_guard<std::mutex> g(p->mu);
        if (!s.open || s.replay.joinable()) return -1;
        s.replay_pkts.assign(data, data + offsets[n_packets]);
        s.replay_offs.assign(offsets, offsets + n_packets + 1);
        s.close_at_end = close_at_end != 0;
        s.replay_stop.store(false);
        s.replaying = true;
    }
    s.replay = std::thread(replay_opus_thread, p, sid, sample_rate, channels,
                           frame_us, start_delay_us);
    return 0;
}

long long skingest_replay_start_ns(void* pool, int sid) {
    auto* p = static_cast<Pool*>(pool);
    std::lock_guard<std::mutex> g(p->mu);
    return p->sessions[sid].replay_start_ns;
}

// drain up to max_blocks completed blocks. Blocks on the condvar up to
// timeout_us when the queue is empty (0 = non-blocking poll). Returns the
// number of blocks written into ids/arrival_ns/samples (caller-allocated;
// samples holds count * block_samples floats).
int skingest_drain(void* pool, int max_blocks, long long timeout_us,
                   int* ids, long long* arrival_ns, float* samples) {
    auto* p = static_cast<Pool*>(pool);
    std::unique_lock<std::mutex> g(p->mu);
    if (p->queue.empty() && timeout_us > 0) {
        p->cv.wait_for(g, std::chrono::microseconds(timeout_us),
                       [&] { return !p->queue.empty(); });
    }
    int count = 0;
    while (count < max_blocks && !p->queue.empty()) {
        Block& b = p->queue.front();
        ids[count] = b.sid;
        arrival_ns[count] = b.arrival_ns;
        memcpy(samples + size_t(count) * p->block_samples, b.samples.data(),
               sizeof(float) * p->block_samples);
        p->queue.pop_front();
        count++;
    }
    return count;
}

int skingest_pending(void* pool) {
    auto* p = static_cast<Pool*>(pool);
    std::lock_guard<std::mutex> g(p->mu);
    return int(p->queue.size());
}

// sessions still open or replaying (bench end-of-run detection)
int skingest_active(void* pool) {
    auto* p = static_cast<Pool*>(pool);
    std::lock_guard<std::mutex> g(p->mu);
    int n = 0;
    for (auto& s : p->sessions)
        if (s.open) n++;
    return n;
}

long long skingest_dropped(void* pool) {
    return static_cast<Pool*>(pool)->dropped_blocks.load();
}

long long skingest_now_ns(void) { return now_ns(); }

}  // extern "C"

// ---------------------------------------------------------------------------
// Batched Opus decode (dlopen libopus, no headers needed).
//
// Why here: the opus decoder node's hot loop is one libopus call per 20 ms
// packet; through Python ctypes each call costs ~2x the decode itself in
// argument marshalling. One C call decodes a whole greedy batch: packets
// arrive concatenated with an offsets table, PCM returns in one contiguous
// [n, max_frame*channels] buffer. Reference parity:
// crates/nodes/src/audio/codecs/opus.rs:102-140 does the same work on a
// spawn_blocking thread.
namespace {

struct OpusBatchCtx {
    void* dec = nullptr;
    int channels = 1;
};

}  // namespace

extern "C" {

// returns nullptr when libopus is unavailable or creation fails
void* skopus_batch_create(int sample_rate, int channels) {
    OpusApi& api = opus_api();
    if (!api.ok) return nullptr;
    int err = 0;
    void* dec = api.create(sample_rate, channels, &err);
    if (err != 0 || !dec) return nullptr;
    auto* ctx = new OpusBatchCtx();
    ctx->dec = dec;
    ctx->channels = channels;
    return ctx;
}

void skopus_batch_destroy(void* p) {
    if (!p) return;
    auto* ctx = static_cast<OpusBatchCtx*>(p);
    if (ctx->dec) opus_api().destroy(ctx->dec);
    delete ctx;
}

// Decode n packets in one call. data = concatenated packet bytes;
// offsets[n+1] delimits packets; out is a [n, max_frame*channels] f32
// buffer; out_lens[i] receives samples-per-channel (or the negative libopus
// error code). Returns the number of successfully decoded packets.
int skopus_batch_decode(void* p, const unsigned char* data, const int32_t* offsets,
                        int n, float* out, int max_frame, int32_t* out_lens) {
    auto* ctx = static_cast<OpusBatchCtx*>(p);
    OpusApi& api = opus_api();
    int ok = 0;
    const int row = max_frame * ctx->channels;
    for (int i = 0; i < n; i++) {
        const unsigned char* pkt = data + offsets[i];
        const int32_t len = offsets[i + 1] - offsets[i];
        const int r = api.decode_float(ctx->dec, pkt, len, out + size_t(i) * row, max_frame, 0);
        out_lens[i] = r;
        if (r >= 0) ok++;
    }
    return ok;
}

}  // extern "C"
