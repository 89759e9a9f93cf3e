// Video decode core of devias_tpu_torch: a copy of the JAX package's
// native/decode_core.cpp (the code below is unchanged).
//
// Random-access frame decoding on top of FFmpeg (libavformat/libavcodec/
// libswscale) in place of the reference's decord dependency (ref
// dataset/kinetics.py:9,301-351): the input pipeline needs
// VideoReader-style `get_batch(indices) -> uint8 RGB frames` with an exact
// frame count.
//
// Design:
//  * open(): demux the whole file once WITHOUT decoding, recording each
//    video packet's pts and keyframe flag -> exact frame count + a
//    pts-ordered index (frame number -> pts, keyframe).
//  * get_batch(): sort requested indices; for each run, seek to the
//    nearest keyframe at-or-before the target and decode forward,
//    converting wanted frames to RGB24 via swscale. Frame-threaded
//    decoding is enabled on the codec.
//  * C ABI (devias_*) consumed via ctypes
//    (devias_tpu_torch/data/native_decode.py, which builds this file at
//    first use with the flags `pkg-config` gives for FFmpeg).

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libswscale/swscale.h>
}

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <vector>

namespace {

struct FrameIndexEntry {
  int64_t pts;
  bool keyframe;
};

struct VideoHandle {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* codec = nullptr;
  SwsContext* sws = nullptr;
  int stream_index = -1;
  int width = 0;
  int height = 0;
  std::vector<FrameIndexEntry> index;  // sorted by pts == display order
  int64_t cur_frame = -1;  // display index of the last decoded frame
  std::mutex mu;
};

// Build the display-order frame index by demuxing all packets once.
bool build_index(VideoHandle* h) {
  AVPacket* pkt = av_packet_alloc();
  if (!pkt) return false;
  std::vector<FrameIndexEntry> entries;
  while (av_read_frame(h->fmt, pkt) >= 0) {
    if (pkt->stream_index == h->stream_index) {
      int64_t ts = pkt->pts != AV_NOPTS_VALUE ? pkt->pts : pkt->dts;
      entries.push_back({ts, (pkt->flags & AV_PKT_FLAG_KEY) != 0});
    }
    av_packet_unref(pkt);
  }
  av_packet_free(&pkt);
  if (entries.empty()) return false;
  // packets arrive in decode order; sort by pts for display order
  std::sort(entries.begin(), entries.end(),
            [](const FrameIndexEntry& a, const FrameIndexEntry& b) {
              return a.pts < b.pts;
            });
  h->index = std::move(entries);
  // rewind for decoding
  av_seek_frame(h->fmt, h->stream_index, h->index.front().pts,
                AVSEEK_FLAG_BACKWARD);
  if (h->codec) avcodec_flush_buffers(h->codec);
  h->cur_frame = -1;
  return true;
}

// display index of the nearest keyframe at or before `target`
int64_t keyframe_before(const VideoHandle* h, int64_t target) {
  for (int64_t i = target; i >= 0; --i) {
    if (h->index[i].keyframe) return i;
  }
  return 0;
}

// frame display index for a given pts (binary search)
int64_t frame_of_pts(const VideoHandle* h, int64_t pts) {
  auto it = std::lower_bound(
      h->index.begin(), h->index.end(), pts,
      [](const FrameIndexEntry& e, int64_t p) { return e.pts < p; });
  if (it == h->index.end()) return (int64_t)h->index.size() - 1;
  return it - h->index.begin();
}

}  // namespace

extern "C" {

static VideoHandle* open_common(const char* path) {
  auto* h = new VideoHandle();
  if (avformat_open_input(&h->fmt, path, nullptr, nullptr) < 0) {
    delete h;
    return nullptr;
  }
  if (avformat_find_stream_info(h->fmt, nullptr) < 0) {
    avformat_close_input(&h->fmt);
    delete h;
    return nullptr;
  }
  const AVCodec* dec = nullptr;
  h->stream_index =
      av_find_best_stream(h->fmt, AVMEDIA_TYPE_VIDEO, -1, -1, &dec, 0);
  if (h->stream_index < 0 || !dec) {
    avformat_close_input(&h->fmt);
    delete h;
    return nullptr;
  }
  AVStream* st = h->fmt->streams[h->stream_index];
  h->codec = avcodec_alloc_context3(dec);
  if (!h->codec ||
      avcodec_parameters_to_context(h->codec, st->codecpar) < 0) {
    if (h->codec) avcodec_free_context(&h->codec);
    avformat_close_input(&h->fmt);
    delete h;
    return nullptr;
  }
  h->codec->thread_count = 0;  // auto (frame threading)
  h->codec->thread_type = FF_THREAD_FRAME;
  if (avcodec_open2(h->codec, dec, nullptr) < 0) {
    avcodec_free_context(&h->codec);
    avformat_close_input(&h->fmt);
    delete h;
    return nullptr;
  }
  h->width = h->codec->width;
  h->height = h->codec->height;
  return h;
}

static void close_handle(VideoHandle* h) {
  avcodec_free_context(&h->codec);
  avformat_close_input(&h->fmt);
  delete h;
}

void* devias_open(const char* path) {
  VideoHandle* h = open_common(path);
  if (!h) return nullptr;
  if (!build_index(h)) {
    close_handle(h);
    return nullptr;
  }
  return h;
}

// Open with a previously exported frame index (devias_export_index),
// skipping the full-file packet scan build_index does. The caller owns
// cache validity (key on path + mtime + size) — a stale index against a
// changed file yields wrong frames, same as any stale index cache.
void* devias_open_cached(const char* path, const int64_t* pts,
                         const int32_t* key, int64_t n) {
  if (n <= 0) return nullptr;
  VideoHandle* h = open_common(path);
  if (!h) return nullptr;
  h->index.resize((size_t)n);
  for (int64_t i = 0; i < n; ++i) h->index[i] = {pts[i], key[i] != 0};
  av_seek_frame(h->fmt, h->stream_index, h->index.front().pts,
                AVSEEK_FLAG_BACKWARD);
  avcodec_flush_buffers(h->codec);
  h->cur_frame = -1;
  return h;
}

// Export the frame index (pts + keyframe flags) for caching; both output
// arrays must hold devias_num_frames(handle) entries.
void devias_export_index(void* handle, int64_t* pts, int32_t* key) {
  auto* h = static_cast<VideoHandle*>(handle);
  for (size_t i = 0; i < h->index.size(); ++i) {
    pts[i] = h->index[i].pts;
    key[i] = h->index[i].keyframe ? 1 : 0;
  }
}

int64_t devias_num_frames(void* handle) {
  auto* h = static_cast<VideoHandle*>(handle);
  return h ? (int64_t)h->index.size() : -1;
}

int32_t devias_frame_size(void* handle, int32_t* height, int32_t* width) {
  auto* h = static_cast<VideoHandle*>(handle);
  if (!h) return -1;
  *height = h->height;
  *width = h->width;
  return 0;
}

// Decode the frames at `indices` (display order, may repeat / be unsorted)
// into out[len, H, W, 3] RGB24.
int32_t devias_get_batch(void* handle, const int64_t* indices, int64_t len,
                         uint8_t* out) {
  auto* h = static_cast<VideoHandle*>(handle);
  if (!h || len <= 0) return -1;
  std::lock_guard<std::mutex> lock(h->mu);
  const int64_t n = (int64_t)h->index.size();
  const size_t frame_bytes = (size_t)h->width * h->height * 3;

  // clamp + sort unique wanted indices
  std::vector<int64_t> wanted(indices, indices + len);
  for (auto& w : wanted) w = std::min(std::max(w, (int64_t)0), n - 1);
  std::vector<int64_t> need = wanted;
  std::sort(need.begin(), need.end());
  need.erase(std::unique(need.begin(), need.end()), need.end());

  // decoded frames keyed by display index (only the needed ones are kept)
  std::vector<std::pair<int64_t, std::vector<uint8_t>>> cache;
  cache.reserve(need.size());

  AVPacket* pkt = av_packet_alloc();
  AVFrame* frame = av_frame_alloc();
  if (!pkt || !frame) {
    if (pkt) av_packet_free(&pkt);
    if (frame) av_frame_free(&frame);
    return -2;
  }

  auto store_frame = [&](int64_t disp_idx) {
    if (!std::binary_search(need.begin(), need.end(), disp_idx)) return;
    if (!h->sws) {
      h->sws = sws_getContext(h->width, h->height, h->codec->pix_fmt,
                              h->width, h->height, AV_PIX_FMT_RGB24,
                              SWS_BILINEAR, nullptr, nullptr, nullptr);
    }
    std::vector<uint8_t> rgb(frame_bytes);
    uint8_t* dst[1] = {rgb.data()};
    int dst_stride[1] = {h->width * 3};
    sws_scale(h->sws, frame->data, frame->linesize, 0, h->height, dst,
              dst_stride);
    cache.emplace_back(disp_idx, std::move(rgb));
  };

  size_t need_pos = 0;
  for (int64_t target : need) {
    // already decoded into cache during a previous forward run?
    bool have = false;
    for (auto& c : cache)
      if (c.first == target) { have = true; break; }
    if (have) continue;

    // seek when the target is behind us or far ahead of the cursor
    if (h->cur_frame < 0 || target < h->cur_frame ||
        target > h->cur_frame + 64) {
      int64_t kf = keyframe_before(h, target);
      if (!(h->cur_frame >= kf && h->cur_frame <= target)) {
        av_seek_frame(h->fmt, h->stream_index, h->index[kf].pts,
                      AVSEEK_FLAG_BACKWARD);
        avcodec_flush_buffers(h->codec);
        h->cur_frame = kf - 1;
      }
    }
    // decode forward until `target` is produced
    bool done = false;
    while (!done) {
      int ret = av_read_frame(h->fmt, pkt);
      if (ret < 0) {
        // flush
        avcodec_send_packet(h->codec, nullptr);
        while (avcodec_receive_frame(h->codec, frame) >= 0) {
          int64_t ts = frame->pts != AV_NOPTS_VALUE
                           ? frame->pts
                           : frame->best_effort_timestamp;
          int64_t disp = frame_of_pts(h, ts);
          h->cur_frame = disp;
          store_frame(disp);
          if (disp >= target) { done = true; }
        }
        break;
      }
      if (pkt->stream_index != h->stream_index) {
        av_packet_unref(pkt);
        continue;
      }
      if (avcodec_send_packet(h->codec, pkt) < 0) {
        av_packet_unref(pkt);
        continue;
      }
      av_packet_unref(pkt);
      while (avcodec_receive_frame(h->codec, frame) >= 0) {
        int64_t ts = frame->pts != AV_NOPTS_VALUE
                         ? frame->pts
                         : frame->best_effort_timestamp;
        int64_t disp = frame_of_pts(h, ts);
        h->cur_frame = disp;
        store_frame(disp);
        if (disp >= target) done = true;
      }
    }
    (void)need_pos;
  }

  av_packet_free(&pkt);
  av_frame_free(&frame);

  // scatter into the caller's order; missing frames (decode gaps) fall
  // back to the nearest available earlier frame
  for (int64_t i = 0; i < len; ++i) {
    int64_t w = wanted[i];
    const std::vector<uint8_t>* best = nullptr;
    int64_t best_idx = -1;
    for (auto& c : cache) {
      if (c.first == w) { best = &c.second; break; }
      if (c.first < w && c.first > best_idx) { best_idx = c.first; best = &c.second; }
    }
    if (!best) {
      if (cache.empty()) return -3;
      best = &cache.front().second;
    }
    std::memcpy(out + (size_t)i * frame_bytes, best->data(), frame_bytes);
  }
  return 0;
}

void devias_close(void* handle) {
  auto* h = static_cast<VideoHandle*>(handle);
  if (!h) return;
  if (h->sws) sws_freeContext(h->sws);
  if (h->codec) avcodec_free_context(&h->codec);
  if (h->fmt) avformat_close_input(&h->fmt);
  delete h;
}

}  // extern "C"
