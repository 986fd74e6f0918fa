// SPDX-License-Identifier: Apache-2.0
//
// libav decode shim: container probe + decode of arbitrary audio streams
// (FLAC/M4A/OGG/MP3/...) to interleaved f32 PCM, through a pull callback.
//
// Counterpart of the reference's symphonia decode path (audio::flac::decoder,
// nodes/src/audio/codecs/flac.rs + the StreamingReader blocking bridge in
// nodes/src/streaming_utils.rs:10-48): the host feeds bytes through a
// blocking read callback running on a worker thread.
//
// C ABI consumed by streamkit_tpu_torch/nodes/codecs/av.py (ctypes); the port's
// copy of native/shims/av_decode.cpp, built by ops/_build.py.

#include <cstdint>
#include <cstring>
#include <string>

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/opt.h>
#include <libswresample/swresample.h>
}

extern "C" {

// Host-provided reader: fill buf with up to buf_size bytes; return count,
// 0 to retry, or -1 on end-of-stream.
typedef int (*SkAvReadCb)(void* opaque, uint8_t* buf, int buf_size);

struct SkAvHandle {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* codec = nullptr;
  AVIOContext* avio = nullptr;
  SwrContext* swr = nullptr;
  AVPacket* pkt = nullptr;
  AVFrame* frame = nullptr;
  int stream_index = -1;
  int sample_rate = 0;
  int channels = 0;
  bool eof = false;
  // leftover converted samples not yet handed out
  std::string pending;  // raw bytes of f32 interleaved
};

static void set_err(char* err, size_t errlen, const std::string& msg) {
  if (err && errlen) {
    std::strncpy(err, msg.c_str(), errlen - 1);
    err[errlen - 1] = '\0';
  }
}

static int read_shim(void* opaque, uint8_t* buf, int buf_size) {
  auto cb_pair = static_cast<std::pair<SkAvReadCb, void*>*>(opaque);
  int n = cb_pair->first(cb_pair->second, buf, buf_size);
  if (n < 0) return AVERROR_EOF;
  if (n == 0) return AVERROR(EAGAIN);
  return n;
}

void* skav_open(SkAvReadCb read_cb, void* cb_opaque, char* err, size_t errlen) {
  auto* h = new SkAvHandle();
  auto* cb_pair = new std::pair<SkAvReadCb, void*>(read_cb, cb_opaque);

  constexpr int kBufSize = 64 * 1024;
  uint8_t* avio_buf = static_cast<uint8_t*>(av_malloc(kBufSize));
  h->avio = avio_alloc_context(avio_buf, kBufSize, 0, cb_pair, read_shim, nullptr, nullptr);
  h->fmt = avformat_alloc_context();
  h->fmt->pb = h->avio;
  if (avformat_open_input(&h->fmt, nullptr, nullptr, nullptr) < 0) {
    set_err(err, errlen, "avformat_open_input failed (unrecognized stream?)");
    delete h;
    return nullptr;
  }
  if (avformat_find_stream_info(h->fmt, nullptr) < 0) {
    set_err(err, errlen, "no stream info");
    avformat_close_input(&h->fmt);
    delete h;
    return nullptr;
  }
  const AVCodec* dec = nullptr;
  h->stream_index = av_find_best_stream(h->fmt, AVMEDIA_TYPE_AUDIO, -1, -1, &dec, 0);
  if (h->stream_index < 0 || !dec) {
    set_err(err, errlen, "no audio stream");
    avformat_close_input(&h->fmt);
    delete h;
    return nullptr;
  }
  h->codec = avcodec_alloc_context3(dec);
  avcodec_parameters_to_context(h->codec, h->fmt->streams[h->stream_index]->codecpar);
  if (avcodec_open2(h->codec, dec, nullptr) < 0) {
    set_err(err, errlen, "decoder open failed");
    avformat_close_input(&h->fmt);
    delete h;
    return nullptr;
  }
  h->sample_rate = h->codec->sample_rate;
  h->channels = h->codec->ch_layout.nb_channels;
  // resample stage: any input format -> packed f32, same rate/channels
  swr_alloc_set_opts2(&h->swr, &h->codec->ch_layout, AV_SAMPLE_FMT_FLT,
                      h->sample_rate, &h->codec->ch_layout,
                      h->codec->sample_fmt, h->sample_rate, 0, nullptr);
  if (!h->swr || swr_init(h->swr) < 0) {
    set_err(err, errlen, "swr init failed");
    avcodec_free_context(&h->codec);
    avformat_close_input(&h->fmt);
    delete h;
    return nullptr;
  }
  h->pkt = av_packet_alloc();
  h->frame = av_frame_alloc();
  return h;
}

int skav_info(void* handle, int* sample_rate, int* channels) {
  auto* h = static_cast<SkAvHandle*>(handle);
  *sample_rate = h->sample_rate;
  *channels = h->channels;
  return 0;
}

// Decode into out (interleaved f32); returns samples written, 0 on EOF, <0 error.
int skav_decode(void* handle, float* out, int max_samples) {
  auto* h = static_cast<SkAvHandle*>(handle);
  auto deliver = [&]() -> int {
    int want_bytes = max_samples * static_cast<int>(sizeof(float));
    int take = static_cast<int>(h->pending.size()) < want_bytes
                   ? static_cast<int>(h->pending.size())
                   : want_bytes;
    take -= take % (static_cast<int>(sizeof(float)) * h->channels);
    if (take <= 0) return 0;
    std::memcpy(out, h->pending.data(), take);
    h->pending.erase(0, take);
    return take / static_cast<int>(sizeof(float));
  };
  if (!h->pending.empty()) {
    int n = deliver();
    if (n > 0) return n;
  }
  while (true) {
    int rc = avcodec_receive_frame(h->codec, h->frame);
    if (rc == 0) {
      int out_count = h->frame->nb_samples;
      int bytes = out_count * h->channels * static_cast<int>(sizeof(float));
      size_t old = h->pending.size();
      h->pending.resize(old + bytes);
      uint8_t* dst = reinterpret_cast<uint8_t*>(&h->pending[old]);
      uint8_t* dst_planes[1] = {dst};
      int conv = swr_convert(h->swr, dst_planes, out_count,
                             const_cast<const uint8_t**>(h->frame->data), out_count);
      if (conv < 0) return -2;
      h->pending.resize(old + conv * h->channels * sizeof(float));
      int n = deliver();
      if (n > 0) return n;
      continue;
    }
    if (rc == AVERROR_EOF) return deliver();
    if (rc != AVERROR(EAGAIN)) return -3;
    if (h->eof) return deliver();
    // need a packet
    rc = av_read_frame(h->fmt, h->pkt);
    if (rc == AVERROR_EOF) {
      h->eof = true;
      avcodec_send_packet(h->codec, nullptr);  // flush
      continue;
    }
    if (rc < 0) return -4;
    if (h->pkt->stream_index == h->stream_index) {
      avcodec_send_packet(h->codec, h->pkt);
    }
    av_packet_unref(h->pkt);
  }
}

void skav_close(void* handle) {
  auto* h = static_cast<SkAvHandle*>(handle);
  if (!h) return;
  av_frame_free(&h->frame);
  av_packet_free(&h->pkt);
  swr_free(&h->swr);
  avcodec_free_context(&h->codec);
  avformat_close_input(&h->fmt);
  delete h;
}

}  // extern "C"
