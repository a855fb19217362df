// of_runtime — native host runtime for mrs_optic_flow_tpu.
//
// The reference's native host layer (OpenCL queue management, UMat buffer
// plumbing, blocking enqueue + readback decode; src/FftMethod.cpp:276-475,
// :1723-1758) maps here to three host-side concerns:
//
//   1. FrameQueue  — a lock-free single-producer/single-consumer ring buffer
//                    decoupling the capture thread from the device-feed
//                    thread (the reference serializes on one blocking queue
//                    plus a `running` flag, src/FftMethod.cpp:1775-1777;
//                    here capture never blocks on compute).
//   2. preprocess  — fixed-point BGR->gray + centred crop on uint8, so only
//                    a quarter of the bytes cross host->HBM (the transfer
//                    cost the reference's README calls out, README.md:85-88).
//   3. Recorder    — timestamped raw-frame log writer/reader: the
//                    rosbag-replay + cv::VideoWriter analog
//                    (src/FftMethod.cpp:1695-1704) without codec deps.
//
// Exposed as a C ABI for ctypes (no pybind11 in this image).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <new>

// ---------------------------------------------------------------------------
// FrameQueue: lock-free SPSC ring buffer of fixed-size frames + timestamps
// ---------------------------------------------------------------------------

namespace {

constexpr std::size_t kCacheLine = 64;

struct FrameQueue {
  std::size_t capacity;     // number of slots (power of two)
  std::size_t frame_bytes;  // bytes per frame
  std::uint8_t* data;       // capacity * frame_bytes
  double* stamps;

  alignas(kCacheLine) std::atomic<std::size_t> head{0};  // consumer index
  alignas(kCacheLine) std::atomic<std::size_t> tail{0};  // producer index

  // drop accounting (observability: the reference silently skips frames on
  // rate overrun, src/optic_flow.cpp:1440; we count them)
  alignas(kCacheLine) std::atomic<std::uint64_t> dropped{0};
};

std::size_t round_up_pow2(std::size_t v) {
  std::size_t p = 1;
  while (p < v) p <<= 1;
  return p;
}

}  // namespace

extern "C" {

void* ofq_create(std::size_t capacity, std::size_t frame_bytes) {
  auto* q = new (std::nothrow) FrameQueue();
  if (!q) return nullptr;
  q->capacity = round_up_pow2(capacity < 2 ? 2 : capacity);
  q->frame_bytes = frame_bytes;
  q->data = static_cast<std::uint8_t*>(std::malloc(q->capacity * frame_bytes));
  q->stamps = static_cast<double*>(std::malloc(q->capacity * sizeof(double)));
  if (!q->data || !q->stamps) {
    std::free(q->data);
    std::free(q->stamps);
    delete q;
    return nullptr;
  }
  return q;
}

void ofq_destroy(void* handle) {
  auto* q = static_cast<FrameQueue*>(handle);
  if (!q) return;
  std::free(q->data);
  std::free(q->stamps);
  delete q;
}

// push: returns 0 on success, -1 if full (frame dropped, counter bumped)
int ofq_push(void* handle, const std::uint8_t* frame, std::size_t len, double stamp) {
  auto* q = static_cast<FrameQueue*>(handle);
  if (len != q->frame_bytes) return -2;
  const std::size_t tail = q->tail.load(std::memory_order_relaxed);
  const std::size_t head = q->head.load(std::memory_order_acquire);
  if (tail - head >= q->capacity) {
    q->dropped.fetch_add(1, std::memory_order_relaxed);
    return -1;
  }
  const std::size_t slot = tail & (q->capacity - 1);
  std::memcpy(q->data + slot * q->frame_bytes, frame, len);
  q->stamps[slot] = stamp;
  q->tail.store(tail + 1, std::memory_order_release);
  return 0;
}

// pop: returns 0 on success, -1 if empty
int ofq_pop(void* handle, std::uint8_t* out, std::size_t len, double* stamp) {
  auto* q = static_cast<FrameQueue*>(handle);
  if (len != q->frame_bytes) return -2;
  const std::size_t head = q->head.load(std::memory_order_relaxed);
  const std::size_t tail = q->tail.load(std::memory_order_acquire);
  if (head == tail) return -1;
  const std::size_t slot = head & (q->capacity - 1);
  std::memcpy(out, q->data + slot * q->frame_bytes, len);
  if (stamp) *stamp = q->stamps[slot];
  q->head.store(head + 1, std::memory_order_release);
  return 0;
}

// pop_latest: drain to the newest frame (real-time mode: stale frames are
// worthless once a newer one exists). Returns number of frames skipped, or
// -1 if empty.
long ofq_pop_latest(void* handle, std::uint8_t* out, std::size_t len, double* stamp) {
  auto* q = static_cast<FrameQueue*>(handle);
  if (len != q->frame_bytes) return -2;
  std::size_t head = q->head.load(std::memory_order_relaxed);
  const std::size_t tail = q->tail.load(std::memory_order_acquire);
  if (head == tail) return -1;
  const std::size_t newest = tail - 1;
  const long skipped = static_cast<long>(newest - head);
  const std::size_t slot = newest & (q->capacity - 1);
  std::memcpy(out, q->data + slot * q->frame_bytes, len);
  if (stamp) *stamp = q->stamps[slot];
  q->head.store(newest + 1, std::memory_order_release);
  return skipped;
}

std::size_t ofq_size(void* handle) {
  auto* q = static_cast<FrameQueue*>(handle);
  return q->tail.load(std::memory_order_acquire) -
         q->head.load(std::memory_order_acquire);
}

std::uint64_t ofq_dropped(void* handle) {
  return static_cast<FrameQueue*>(handle)->dropped.load(std::memory_order_relaxed);
}

// gather_latest: drain each of n queues to its newest frame into one
// contiguous [n, frame_bytes] batch — ONE native call per fleet tick
// instead of n ctypes round-trips.  mask[i] = 1 when queue i produced a
// frame (its batch slot and stamp are written), 0 when it was empty (slot
// untouched — the caller keeps its previous frame there).  Returns the
// total number of stale frames skipped across queues, or -2 on a
// frame_bytes mismatch.
long ofq_gather_latest(void** handles, int n, std::uint8_t* batch,
                       std::size_t frame_bytes, double* stamps,
                       std::uint8_t* mask) {
  long total_skipped = 0;
  for (int i = 0; i < n; ++i) {
    auto* q = static_cast<FrameQueue*>(handles[i]);
    if (q->frame_bytes != frame_bytes) return -2;
    const long r = ofq_pop_latest(handles[i], batch + static_cast<std::size_t>(i) * frame_bytes,
                                  frame_bytes, stamps + i);
    if (r < 0) {
      mask[i] = 0;
    } else {
      mask[i] = 1;
      total_skipped += r;
    }
  }
  return total_skipped;
}

// ---------------------------------------------------------------------------
// preprocess: fixed-point grayscale + crop on uint8
// ---------------------------------------------------------------------------

// OpenCV's RGB2GRAY fixed-point weights: (R*4899 + G*9617 + B*1868 + 8192)>>14.
// swap_rb=1 reproduces the reference's CV_RGB2GRAY-on-BGR quirk
// (src/optic_flow.cpp:1465, :1622): the 0.299 weight lands on channel 0
// (blue in a BGR buffer).
void ofp_bgr_to_gray(const std::uint8_t* src, int h, int w, std::uint8_t* dst,
                     int swap_rb) {
  const int w0 = swap_rb ? 4899 : 1868;   // channel 0 weight
  const int w1 = 9617;                    // channel 1 (green)
  const int w2 = swap_rb ? 1868 : 4899;   // channel 2 weight
  const std::int64_t n = static_cast<std::int64_t>(h) * w;
  for (std::int64_t i = 0; i < n; ++i) {
    const std::uint8_t* p = src + 3 * i;
    dst[i] = static_cast<std::uint8_t>((p[0] * w0 + p[1] * w1 + p[2] * w2 + 8192) >> 14);
  }
}

// centred crop: size x size window at (cx - size/2, cy - size/2), clamped.
void ofp_crop(const std::uint8_t* src, int h, int w, int cx, int cy, int size,
              std::uint8_t* dst) {
  // clamp the window into bounds; the >= 0 clamp comes LAST so a size
  // larger than the image can never drive the origin negative (an
  // out-of-bounds read) — the Python wrappers reject size > w/h up front
  int x0 = cx - size / 2;
  int y0 = cy - size / 2;
  if (x0 + size > w) x0 = w - size;
  if (y0 + size > h) y0 = h - size;
  if (x0 < 0) x0 = 0;
  if (y0 < 0) y0 = 0;
  for (int y = 0; y < size; ++y)
    std::memcpy(dst + static_cast<std::size_t>(y) * size,
                src + static_cast<std::size_t>(y0 + y) * w + x0, size);
}

// fused gray+crop: converts only the cropped window (size^2 pixels instead
// of h*w) — the host does 9x less work for the default 480^2-of-752x480.
void ofp_gray_crop(const std::uint8_t* bgr, int h, int w, int cx, int cy,
                   int size, int swap_rb, std::uint8_t* dst) {
  const int w0 = swap_rb ? 4899 : 1868;
  const int w1 = 9617;
  const int w2 = swap_rb ? 1868 : 4899;
  // clamp the window into bounds; the >= 0 clamp comes LAST so a size
  // larger than the image can never drive the origin negative (an
  // out-of-bounds read) — the Python wrappers reject size > w/h up front
  int x0 = cx - size / 2;
  int y0 = cy - size / 2;
  if (x0 + size > w) x0 = w - size;
  if (y0 + size > h) y0 = h - size;
  if (x0 < 0) x0 = 0;
  if (y0 < 0) y0 = 0;
  for (int y = 0; y < size; ++y) {
    const std::uint8_t* row = bgr + 3 * (static_cast<std::size_t>(y0 + y) * w + x0);
    std::uint8_t* out = dst + static_cast<std::size_t>(y) * size;
    for (int x = 0; x < size; ++x) {
      const std::uint8_t* p = row + 3 * x;
      out[x] = static_cast<std::uint8_t>((p[0] * w0 + p[1] * w1 + p[2] * w2 + 8192) >> 14);
    }
  }
}

// ---------------------------------------------------------------------------
// Recorder: timestamped raw-frame log (write + indexed read)
// ---------------------------------------------------------------------------

namespace {

struct RecorderHeader {
  char magic[8];  // "OFRECv1\0"
  std::int32_t width, height, channels;
  std::int32_t reserved;
};

struct Recorder {
  FILE* f;
  RecorderHeader hdr;
  long n_frames;
  std::size_t frame_bytes;
  bool writing;
};

constexpr char kMagic[8] = {'O', 'F', 'R', 'E', 'C', 'v', '1', '\0'};

}  // namespace

void* ofr_open_write(const char* path, int w, int h, int channels) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return nullptr;
  auto* r = new Recorder();
  std::memcpy(r->hdr.magic, kMagic, 8);
  r->hdr.width = w;
  r->hdr.height = h;
  r->hdr.channels = channels;
  r->hdr.reserved = 0;
  r->f = f;
  r->n_frames = 0;
  r->frame_bytes = static_cast<std::size_t>(w) * h * channels;
  r->writing = true;
  std::fwrite(&r->hdr, sizeof(r->hdr), 1, f);
  return r;
}

int ofr_write(void* handle, double stamp, const std::uint8_t* frame) {
  auto* r = static_cast<Recorder*>(handle);
  if (!r->writing) return -1;
  if (std::fwrite(&stamp, sizeof(double), 1, r->f) != 1) return -1;
  if (std::fwrite(frame, 1, r->frame_bytes, r->f) != r->frame_bytes) return -1;
  ++r->n_frames;
  return 0;
}

void* ofr_open_read(const char* path, int* w, int* h, int* ch, long* n_frames) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  auto* r = new Recorder();
  if (std::fread(&r->hdr, sizeof(r->hdr), 1, f) != 1 ||
      std::memcmp(r->hdr.magic, kMagic, 8) != 0) {
    std::fclose(f);
    delete r;
    return nullptr;
  }
  r->f = f;
  r->writing = false;
  r->frame_bytes =
      static_cast<std::size_t>(r->hdr.width) * r->hdr.height * r->hdr.channels;
  std::fseek(f, 0, SEEK_END);
  const long sz = std::ftell(f);
  r->n_frames = (sz - static_cast<long>(sizeof(r->hdr))) /
                static_cast<long>(sizeof(double) + r->frame_bytes);
  if (w) *w = r->hdr.width;
  if (h) *h = r->hdr.height;
  if (ch) *ch = r->hdr.channels;
  if (n_frames) *n_frames = r->n_frames;
  return r;
}

int ofr_read(void* handle, long idx, double* stamp, std::uint8_t* out) {
  auto* r = static_cast<Recorder*>(handle);
  if (r->writing || idx < 0 || idx >= r->n_frames) return -1;
  const long off = static_cast<long>(sizeof(RecorderHeader)) +
                   idx * static_cast<long>(sizeof(double) + r->frame_bytes);
  if (std::fseek(r->f, off, SEEK_SET) != 0) return -1;
  if (std::fread(stamp, sizeof(double), 1, r->f) != 1) return -1;
  if (std::fread(out, 1, r->frame_bytes, r->f) != r->frame_bytes) return -1;
  return 0;
}

void ofr_close(void* handle) {
  auto* r = static_cast<Recorder*>(handle);
  if (!r) return;
  std::fclose(r->f);
  delete r;
}

}  // extern "C"
