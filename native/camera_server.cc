// Native camera server daemon.
//
// C++ counterpart of the reference's pcs-camera-server (reference:
// src/pcs-camera-server.cpp — SURVEY.md §3.1): bind/listen/accept, then one
// depth frame per 1-byte pull request, snappy-compressed, length-prefixed.
// Per the rebuild plan (SURVEY.md §2.1 native checklist), capture + socket
// ingest stay native on the host while all geometry runs on the accelerator, so the
// wire carries raw u16 depth (DEPTH16 frames of runtime/wire.py).
//
// Frame sources (all implement the FrameSource interface below):
//   --file scene.npy   replay a [T, H, W] uint16 .npy recording (the format
//                      MulticameraClient.save_recording writes)
//   --synthetic        procedural multi-octave scene (matches the Python
//                      generator's character, not its exact values)
//   --rs2              live librealsense D400 capture (the reference's
//                      rs2::pipeline loop — SURVEY.md §3.1). Compiled in
//                      only with -DPCS_WITH_RS2 (librealsense2 is not
//                      installable in this build environment, so CI
//                      compile-checks the source against the stub headers
//                      in native/rs2_stub/ — see make native-server-rs2check
//                      — and a rig operator builds `make native-server-rs2`
//                      against the real SDK).
//
// Build: make native-server  (or scripts in native/)
//
// Wire header (little-endian, 16 bytes — see runtime/wire.py):
//   u32 payload_size | u8 kind | u8 codec | u8 flags | u8 rsvd |
//   u32 seq | u16 rows | u16 cols

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#ifdef PCS_WITH_RS2
#include <librealsense2/rs.hpp>
#endif

extern "C" {
size_t pcs_snappy_max_compressed_length(size_t n);
size_t pcs_snappy_compress(const uint8_t* in, size_t n, uint8_t* out);
}

namespace {

constexpr uint8_t kKindDepth16 = 0;
constexpr uint8_t kKindDepth16Color = 2;
constexpr uint8_t kCodecRaw = 0;
constexpr uint8_t kCodecSnappy = 2;

struct Frames {
  size_t t = 0, h = 0, w = 0;
  std::vector<uint16_t> data;
  std::vector<uint8_t> rgb;  // empty, or [t, h, w, 3] depth-aligned color
  const uint16_t* frame(size_t i) const { return data.data() + (i % t) * h * w; }
  const uint8_t* color(size_t i) const { return rgb.data() + (i % t) * h * w * 3; }
};

// Synthetic depth-aligned RGB, same formula as the Python fake server
// (runtime/fake_server.py): hue from depth, stable per pixel.
void make_colors(Frames* fr) {
  fr->rgb.resize(fr->data.size() * 3);
  for (size_t i = 0; i < fr->data.size(); ++i) {
    const float d = static_cast<float>(fr->data[i]);
    auto clip = [](float x) {
      return static_cast<uint8_t>(x < 0.f ? 0.f : (x > 255.f ? 255.f : x));
    };
    fr->rgb[i * 3 + 0] = clip(d / 16.0f);
    fr->rgb[i * 3 + 1] = clip(255.0f - d / 16.0f);
    fr->rgb[i * 3 + 2] = 128;
  }
}

// Minimal .npy (v1/v2) reader for little-endian uint16 C-order arrays.
bool load_npy_u16(const std::string& path, Frames* out) {
  std::ifstream f(path, std::ios::binary);
  if (!f) return false;
  char magic[6];
  f.read(magic, 6);
  if (std::memcmp(magic, "\x93NUMPY", 6) != 0) return false;
  uint8_t ver[2];
  f.read(reinterpret_cast<char*>(ver), 2);
  uint32_t hlen = 0;
  if (ver[0] == 1) {
    uint16_t h16;
    f.read(reinterpret_cast<char*>(&h16), 2);
    hlen = h16;
  } else {
    f.read(reinterpret_cast<char*>(&hlen), 4);
  }
  std::string header(hlen, '\0');
  f.read(header.data(), hlen);
  if (header.find("'<u2'") == std::string::npos &&
      header.find("'|u2'") == std::string::npos &&
      header.find("uint16") == std::string::npos) {
    std::fprintf(stderr, "npy: expected uint16 ('<u2'), got: %s\n",
                 header.c_str());
    return false;
  }
  if (header.find("'fortran_order': False") == std::string::npos) return false;
  auto sp = header.find("'shape':");
  if (sp == std::string::npos) return false;
  size_t t, h, w;
  if (std::sscanf(header.c_str() + sp, "'shape': (%zu, %zu, %zu)",
                  &t, &h, &w) != 3)
    return false;
  out->t = t; out->h = h; out->w = w;
  out->data.resize(t * h * w);
  f.read(reinterpret_cast<char*>(out->data.data()),
         static_cast<std::streamsize>(out->data.size() * 2));
  return static_cast<bool>(f);
}

Frames synthetic_frames(size_t t, size_t h, size_t w, unsigned seed) {
  Frames fr;
  fr.t = t; fr.h = h; fr.w = w;
  fr.data.resize(t * h * w);
  unsigned state = seed * 2654435761u + 1u;
  auto rnd = [&state]() {
    state = state * 1664525u + 1013904223u;
    return (state >> 8) * (1.0f / 16777216.0f);
  };
  for (size_t k = 0; k < t; ++k) {
    const float p = 0.02f * static_cast<float>(k);
    for (size_t v = 0; v < h; ++v) {
      for (size_t u = 0; u < w; ++u) {
        float d = 1500.f
            + 500.f * std::sin(static_cast<float>(u) / (w * 0.23f) + p)
            + 400.f * std::cos(static_cast<float>(v) / (h * 0.19f))
            + 150.f * std::sin(static_cast<float>(u) / (w * 0.041f) + 1.f + p)
            + 120.f * std::cos(static_cast<float>(v) / (h * 0.037f));
        if (rnd() < 0.07f) d = 0.f;
        if (d < 0.f) d = 0.f;
        if (d > 4000.f) d = 4000.f;
        fr.data[(k * h + v) * w + u] = static_cast<uint16_t>(d);
      }
    }
  }
  return fr;
}

bool send_all(int fd, const uint8_t* p, size_t n) {
  while (n > 0) {
    ssize_t r = ::send(fd, p, n, 0);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

// Polymorphic capture seam: the serve loop below is source-agnostic, so a
// deployment swaps replay for live capture by constructing a different
// FrameSource (the reference's equivalent is the rs2 calls hard-wired into
// its serve loop — src/pcs-camera-server.cpp, SURVEY.md §3.1).
class FrameSource {
 public:
  virtual ~FrameSource() = default;
  virtual size_t height() const = 0;
  virtual size_t width() const = 0;
  virtual bool has_color() const = 0;
  // Copy the next frame into depth [h*w] (and rgb [h*w*3] when has_color
  // and rgb != nullptr). Blocks until a frame is available (this is where
  // capture paces the stream); false = permanent source failure.
  virtual bool next(uint16_t* depth, uint8_t* rgb) = 0;
};

// Replay/synthetic source over a preloaded Frames block. Per-instance
// cursor: each client connection streams its own cycle from frame 0,
// matching the Python fake server's semantics.
class ReplaySource : public FrameSource {
 public:
  ReplaySource(const Frames& fr, double fps) : fr_(fr), fps_(fps) {}
  size_t height() const override { return fr_.h; }
  size_t width() const override { return fr_.w; }
  bool has_color() const override { return !fr_.rgb.empty(); }
  bool next(uint16_t* depth, uint8_t* rgb) override {
    if (fps_ > 0.0) {
      auto next_t = last_ + std::chrono::duration_cast<
          std::chrono::steady_clock::duration>(
              std::chrono::duration<double>(1.0 / fps_));
      std::this_thread::sleep_until(next_t);
      last_ = std::chrono::steady_clock::now();
    }
    std::memcpy(depth, fr_.frame(seq_), fr_.h * fr_.w * 2);
    if (rgb && has_color())
      std::memcpy(rgb, fr_.color(seq_), fr_.h * fr_.w * 3);
    ++seq_;
    return true;
  }

 private:
  const Frames& fr_;
  double fps_;
  size_t seq_ = 0;
  std::chrono::steady_clock::time_point last_ =
      std::chrono::steady_clock::now();
};

#ifdef PCS_WITH_RS2
// Live RealSense D400 capture: the reference camera server's rs2::pipeline
// loop (SURVEY.md §3.1) minus camera-side deprojection — the wire carries
// raw u16 depth and deprojection runs on the accelerator. Color (when enabled) is
// aligned onto the depth grid with rs2::align so the payload stays
// DEPTH16_COLOR. Thread-safe: one pipeline shared by every client
// connection (frames are consumed jointly — a live camera has one "now").
class Rs2Source : public FrameSource {
 public:
  Rs2Source(size_t width, size_t height, int fps, bool color)
      : w_(width), h_(height), color_(color), align_(RS2_STREAM_DEPTH) {
    rs2::config cfg;
    cfg.enable_stream(RS2_STREAM_DEPTH, static_cast<int>(width),
                      static_cast<int>(height), RS2_FORMAT_Z16, fps);
    if (color)
      cfg.enable_stream(RS2_STREAM_COLOR, static_cast<int>(width),
                        static_cast<int>(height), RS2_FORMAT_RGB8, fps);
    profile_ = pipe_.start(cfg);
    print_intrinsics();
  }
  size_t height() const override { return h_; }
  size_t width() const override { return w_; }
  bool has_color() const override { return color_; }
  bool next(uint16_t* depth, uint8_t* rgb) override {
    std::lock_guard<std::mutex> lock(mu_);
    try {
      rs2::frameset fs = pipe_.wait_for_frames();
      if (color_) fs = align_.process(fs);
      rs2::depth_frame d = fs.get_depth_frame();
      if (!d) return false;
      std::memcpy(depth, d.get_data(), h_ * w_ * 2);
      if (color_ && rgb) {
        rs2::video_frame c = fs.get_color_frame();
        if (c) std::memcpy(rgb, c.get_data(), h_ * w_ * 3);
      }
    } catch (const rs2::error& e) {
      std::fprintf(stderr, "rs2 capture failed: %s\n", e.what());
      return false;
    }
    return true;
  }

 private:
  // Emit the factory depth intrinsics in the .intr.json schema
  // (io/calio.py) so a rig operator can redirect stdout into the file the
  // stitcher loads via --intr-dir — the same out-of-band channel as the
  // Python daemon's --dump-intrinsics.
  void print_intrinsics() {
    rs2::video_stream_profile vs =
        profile_.get_stream(RS2_STREAM_DEPTH)
            .as<rs2::video_stream_profile>();
    rs2_intrinsics in = vs.get_intrinsics();
    std::printf(
        "{\"width\": %d, \"height\": %d, \"fx\": %.6f, \"fy\": %.6f, "
        "\"ppx\": %.6f, \"ppy\": %.6f, \"model\": %d, "
        "\"coeffs\": [%.6f, %.6f, %.6f, %.6f, %.6f]}\n",
        in.width, in.height, in.fx, in.fy, in.ppx, in.ppy,
        static_cast<int>(in.model), in.coeffs[0], in.coeffs[1],
        in.coeffs[2], in.coeffs[3], in.coeffs[4]);
    std::fflush(stdout);
  }
  size_t w_, h_;
  bool color_;
  rs2::pipeline pipe_;
  rs2::pipeline_profile profile_;
  rs2::align align_;
  std::mutex mu_;
};
#endif  // PCS_WITH_RS2

void serve_client(int fd, FrameSource& src, uint8_t codec) {
  const bool with_color = src.has_color();
  const size_t h = src.height(), w = src.width();
  const size_t depth_len = h * w * 2;
  const size_t raw_len = depth_len + (with_color ? h * w * 3 : 0);
  // staging layout IS the DEPTH16[_COLOR] payload: depth block, RGB block
  std::vector<uint8_t> staging(raw_len);
  std::vector<uint8_t> out(16 + pcs_snappy_max_compressed_length(raw_len));
  uint32_t seq = 0;
  for (;;) {
    uint8_t pull;
    if (::recv(fd, &pull, 1, MSG_WAITALL) != 1) return;
    if (!src.next(reinterpret_cast<uint16_t*>(staging.data()),
                  with_color ? staging.data() + depth_len : nullptr))
      return;
    size_t body;
    if (codec == kCodecSnappy) {
      body = pcs_snappy_compress(staging.data(), raw_len, out.data() + 16);
    } else {
      std::memcpy(out.data() + 16, staging.data(), raw_len);
      body = raw_len;
    }
    uint32_t size32 = static_cast<uint32_t>(body);
    uint16_t rows = static_cast<uint16_t>(h);
    uint16_t cols = static_cast<uint16_t>(w);
    std::memcpy(out.data() + 0, &size32, 4);
    out[4] = with_color ? kKindDepth16Color : kKindDepth16;
    out[5] = codec;
    out[6] = 0;
    out[7] = 0;
    std::memcpy(out.data() + 8, &seq, 4);
    std::memcpy(out.data() + 12, &rows, 2);
    std::memcpy(out.data() + 14, &cols, 2);
    if (!send_all(fd, out.data(), 16 + body)) return;
    ++seq;
  }
}

}  // namespace

int main(int argc, char** argv) {
  int port = 8000;
  std::string file;
  bool synthetic = false, rs2_mode = false;
  size_t n_frames = 64, height = 480, width = 848;
  unsigned seed = 0;
  uint8_t codec = kCodecSnappy;
  double fps = 0.0;
  bool color = false;
  for (int i = 1; i < argc; ++i) {
    std::string a = argv[i];
    auto next = [&]() { return std::string(argv[++i]); };
    if (a == "--port") port = std::stoi(next());
    else if (a == "--file") file = next();
    else if (a == "--color") color = true;
    else if (a == "--synthetic") synthetic = true;
    else if (a == "--rs2") rs2_mode = true;
    else if (a == "--n-frames") n_frames = std::stoul(next());
    else if (a == "--height") height = std::stoul(next());
    else if (a == "--width") width = std::stoul(next());
    else if (a == "--seed") seed = std::stoul(next());
    else if (a == "--fps") fps = std::stod(next());
    else if (a == "--codec") codec = next() == "raw" ? kCodecRaw
                                                     : kCodecSnappy;
    else {
      std::fprintf(stderr,
                   "usage: %s [--port P] (--file X.npy | --synthetic | "
                   "--rs2) [--n-frames T --height H --width W --seed S] "
                   "[--fps F] [--codec snappy|raw] [--color]\n", argv[0]);
      return 2;
    }
  }

  Frames fr;
  std::unique_ptr<FrameSource> live;
  if (rs2_mode) {
#ifdef PCS_WITH_RS2
    try {
      live = std::make_unique<Rs2Source>(width, height,
                                         fps > 0.0 ? static_cast<int>(fps)
                                                   : 30,
                                         color);
    } catch (const rs2::error& e) {
      std::fprintf(stderr, "rs2 pipeline start failed: %s\n", e.what());
      return 1;
    }
#else
    std::fprintf(stderr,
                 "--rs2 requires a build with librealsense2: "
                 "make native-server-rs2\n");
    return 2;
#endif
  } else if (!file.empty()) {
    if (!load_npy_u16(file, &fr)) {
      std::fprintf(stderr, "failed to load %s\n", file.c_str());
      return 1;
    }
  } else if (synthetic) {
    fr = synthetic_frames(n_frames, height, width, seed);
  } else {
    std::fprintf(stderr, "need --file, --synthetic, or --rs2\n");
    return 2;
  }
  if (color && !rs2_mode) make_colors(&fr);

  int srv = ::socket(AF_INET, SOCK_STREAM, 0);
  int one = 1;
  ::setsockopt(srv, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (::bind(srv, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0 ||
      ::listen(srv, 4) != 0) {
    std::perror("bind/listen");
    return 1;
  }
  // banner goes to stderr: stdout is reserved for machine-readable output
  // (the --rs2 intrinsics JSON that operators redirect into an .intr.json
  // file — a banner on the same stream would corrupt the json.load)
  if (live)
    std::fprintf(stderr,
                 "native camera server on 0.0.0.0:%d (rs2 live %zux%zu)\n",
                 port, live->width(), live->height());
  else
    std::fprintf(stderr,
                 "native camera server on 0.0.0.0:%d (%zu frames %zux%zu)\n",
                 port, fr.t, fr.h, fr.w);
  std::fflush(stderr);
  for (;;) {
    int fd = ::accept(srv, nullptr, nullptr);
    if (fd < 0) continue;
    ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    if (live) {
      // live capture: all clients share the one pipeline (Rs2Source locks)
      std::thread([fd, &live, codec]() {
        serve_client(fd, *live, codec);
        ::close(fd);
      }).detach();
    } else {
      // replay: each client gets its own cursor from frame 0
      std::thread([fd, &fr, codec, fps]() {
        ReplaySource src(fr, fps);
        serve_client(fd, src, codec);
        ::close(fd);
      }).detach();
    }
  }
}
