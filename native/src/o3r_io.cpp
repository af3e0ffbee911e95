// Native IO runtime for online_3d_reconstruction.
//
// The reference's ingest layer is native C++ (cv::imread + Boost.Filesystem,
// SURVEY.md §2.1 C2); this library is its counterpart in this framework: image
// decoding (PNG via libpng, JPEG via libjpeg — the formats real survey
// cameras produce — plus PGM/PPM binary and the numpy .npy float32/uint8
// containers the framework uses for lossless stereo data) and an ordered
// multi-threaded prefetcher that keeps N decoded frames ahead of the
// consumer, so host disk IO and decode overlap device compute (stage P5).
//
// C ABI only — consumed from Python via ctypes (io/native_loader.py).
// Build: native/build.sh -> native/libo3r_io.so

#include <atomic>
#include <climits>
#include <condition_variable>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>

extern "C" {

struct O3RImage {
  int32_t height;
  int32_t width;
  int32_t channels;   // 1 or 3
  int32_t is_float;   // 1: float32 data, 0: uint8
  void* data;         // owned by the library; freed by o3r_image_free
};

// ---------------------------------------------------------------------------
// Decoders
// ---------------------------------------------------------------------------

static bool read_file(const char* path, std::vector<uint8_t>& out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (size < 0) { std::fclose(f); return false; }
  out.resize(static_cast<size_t>(size));
  size_t got = std::fread(out.data(), 1, out.size(), f);
  std::fclose(f);
  return got == out.size();
}

// PGM (P5) / PPM (P6): whitespace-separated header then raw bytes.
static bool decode_pnm(const std::vector<uint8_t>& buf, O3RImage* img) {
  if (buf.size() < 2 || buf[0] != 'P') return false;
  int channels = buf[1] == '5' ? 1 : (buf[1] == '6' ? 3 : 0);
  if (!channels) return false;
  size_t pos = 2;
  long vals[3];
  for (int v = 0; v < 3; ++v) {
    // skip whitespace + comments
    while (pos < buf.size()) {
      if (buf[pos] == '#') { while (pos < buf.size() && buf[pos] != '\n') ++pos; }
      else if (std::isspace(buf[pos])) ++pos;
      else break;
    }
    long x = 0; bool any = false;
    while (pos < buf.size() && std::isdigit(buf[pos])) {
      x = x * 10 + (buf[pos] - '0'); ++pos; any = true;
    }
    if (!any) return false;
    vals[v] = x;
  }
  if (pos >= buf.size() || !std::isspace(buf[pos])) return false;
  ++pos;  // single whitespace after maxval
  long w = vals[0], h = vals[1], maxv = vals[2];
  if (maxv > 255 || w <= 0 || h <= 0) return false;
  size_t need = static_cast<size_t>(w) * h * channels;
  if (buf.size() - pos < need) return false;
  uint8_t* data = static_cast<uint8_t*>(std::malloc(need));
  if (!data) return false;
  std::memcpy(data, buf.data() + pos, need);
  img->height = static_cast<int32_t>(h);
  img->width = static_cast<int32_t>(w);
  img->channels = channels;
  img->is_float = 0;
  img->data = data;
  return true;
}

// Minimal .npy v1/v2 reader for C-contiguous arrays of <f4 or |u1,
// shape (H, W) or (H, W, C).
static bool decode_npy(const std::vector<uint8_t>& buf, O3RImage* img) {
  static const char magic[] = "\x93NUMPY";
  if (buf.size() < 10 || std::memcmp(buf.data(), magic, 6) != 0) return false;
  uint8_t major = buf[6];
  size_t header_len, header_off;
  if (major == 1) {
    header_len = buf[8] | (buf[9] << 8);
    header_off = 10;
  } else {
    if (buf.size() < 12) return false;
    header_len = buf[8] | (buf[9] << 8) | (buf[10] << 16)
                 | (static_cast<size_t>(buf[11]) << 24);
    header_off = 12;
  }
  if (buf.size() < header_off + header_len) return false;
  std::string header(reinterpret_cast<const char*>(buf.data() + header_off),
                     header_len);
  bool is_float;
  if (header.find("'<f4'") != std::string::npos) is_float = true;
  else if (header.find("'|u1'") != std::string::npos) is_float = false;
  else return false;
  if (header.find("'fortran_order': False") == std::string::npos) return false;
  size_t sp = header.find("'shape': (");
  if (sp == std::string::npos) return false;
  sp += 10;
  long dims[3] = {0, 0, 1};
  int nd = 0;
  while (nd < 3) {
    while (sp < header.size() && (header[sp] == ' ' || header[sp] == ',')) ++sp;
    if (sp < header.size() && header[sp] == ')') break;
    long x = 0; bool any = false;
    while (sp < header.size() && std::isdigit(header[sp])) {
      x = x * 10 + (header[sp] - '0'); ++sp; any = true;
    }
    if (!any) break;
    dims[nd++] = x;
  }
  if (nd < 2) return false;
  size_t elems = static_cast<size_t>(dims[0]) * dims[1] * dims[2];
  size_t bytes = elems * (is_float ? 4 : 1);
  size_t data_off = header_off + header_len;
  if (buf.size() - data_off < bytes) return false;
  void* data = std::malloc(bytes);
  if (!data) return false;
  std::memcpy(data, buf.data() + data_off, bytes);
  img->height = static_cast<int32_t>(dims[0]);
  img->width = static_cast<int32_t>(dims[1]);
  img->channels = static_cast<int32_t>(dims[2]);
  img->is_float = is_float ? 1 : 0;
  img->data = data;
  return true;
}

// PNG via libpng's simplified API: grayscale sources decode to 1 channel,
// everything else (palette, RGB, RGBA) to 8-bit RGB — matching what
// cv2.imread + BGR2RGB delivers for the same file.
static bool decode_png(const std::vector<uint8_t>& buf, O3RImage* img) {
  if (buf.size() < 8 || png_sig_cmp(buf.data(), 0, 8) != 0) return false;
  png_image pimg;
  std::memset(&pimg, 0, sizeof(pimg));
  pimg.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_memory(&pimg, buf.data(), buf.size()))
    return false;
  bool gray = (pimg.format & PNG_FORMAT_FLAG_COLOR) == 0;
  pimg.format = gray ? PNG_FORMAT_GRAY : PNG_FORMAT_RGB;
  int channels = gray ? 1 : 3;
  size_t bytes = PNG_IMAGE_SIZE(pimg);
  uint8_t* data = static_cast<uint8_t*>(std::malloc(bytes));
  if (!data) { png_image_free(&pimg); return false; }
  if (!png_image_finish_read(&pimg, nullptr, data, 0, nullptr)) {
    std::free(data);
    png_image_free(&pimg);
    return false;
  }
  img->height = static_cast<int32_t>(pimg.height);
  img->width = static_cast<int32_t>(pimg.width);
  img->channels = channels;
  img->is_float = 0;
  img->data = data;
  return true;
}

// JPEG via libjpeg with a longjmp error handler (the default handler calls
// exit(); a corrupt frame must not kill the pipeline).
struct JpegErr {
  jpeg_error_mgr mgr;
  std::jmp_buf jump;
};

static void jpeg_err_exit(j_common_ptr cinfo) {
  std::longjmp(reinterpret_cast<JpegErr*>(cinfo->err)->jump, 1);
}

static bool decode_jpeg(const std::vector<uint8_t>& buf, O3RImage* img) {
  if (buf.size() < 3 || buf[0] != 0xFF || buf[1] != 0xD8) return false;
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  uint8_t* data = nullptr;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    if (data) std::free(data);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, buf.data(), buf.size());
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  bool gray = cinfo.jpeg_color_space == JCS_GRAYSCALE;
  cinfo.out_color_space = gray ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_start_decompress(&cinfo);
  int channels = cinfo.output_components;
  size_t stride = static_cast<size_t>(cinfo.output_width) * channels;
  data = static_cast<uint8_t*>(std::malloc(stride * cinfo.output_height));
  if (!data) { jpeg_destroy_decompress(&cinfo); return false; }
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = data + stride * cinfo.output_scanline;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  img->height = static_cast<int32_t>(cinfo.output_height);
  img->width = static_cast<int32_t>(cinfo.output_width);
  img->channels = channels;
  img->is_float = 0;
  img->data = data;
  jpeg_destroy_decompress(&cinfo);
  return true;
}

int32_t o3r_read_image(const char* path, O3RImage* img) {
  std::vector<uint8_t> buf;
  if (!read_file(path, buf)) return -1;
  img->data = nullptr;
  if (decode_npy(buf, img)) return 0;
  if (decode_png(buf, img)) return 0;
  if (decode_jpeg(buf, img)) return 0;
  if (decode_pnm(buf, img)) return 0;
  return -2;  // unsupported format
}

void o3r_image_free(O3RImage* img) {
  if (img && img->data) {
    std::free(img->data);
    img->data = nullptr;
  }
}

// ---------------------------------------------------------------------------
// Ordered prefetcher: worker pool decodes frames ahead, consumer pops in order
// ---------------------------------------------------------------------------

struct Prefetcher {
  std::vector<std::string> paths;
  size_t depth;
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_produce, cv_consume;
  // slot i holds the decoded image for frame (next_out + k) ring positions
  std::vector<O3RImage> ring;
  static constexpr int32_t kEmpty = INT32_MIN;  // decode rcs are small negatives
  std::vector<int32_t> status;     // kEmpty, or the frame's decode rc (0 = ok)
  std::atomic<size_t> next_claim{0};
  size_t next_out = 0;
  bool stop = false;

  Prefetcher(const char** p, int32_t n, int32_t d, int32_t n_threads)
      : paths(p, p + n), depth(static_cast<size_t>(d)),
        ring(depth), status(depth, kEmpty) {
    for (auto& im : ring) im.data = nullptr;
    int nt = n_threads > 0 ? n_threads : 2;
    for (int t = 0; t < nt; ++t)
      workers.emplace_back([this] { this->work(); });
  }

  void work() {
    for (;;) {
      size_t idx = next_claim.fetch_add(1);
      if (idx >= paths.size()) return;
      O3RImage img; img.data = nullptr;
      int32_t rc = o3r_read_image(paths[idx].c_str(), &img);
      std::unique_lock<std::mutex> lk(mu);
      // wait until frame idx's ring slot is free (within `depth` of next_out)
      cv_produce.wait(lk, [&] { return stop || idx < next_out + depth; });
      if (stop) { if (img.data) std::free(img.data); return; }
      size_t slot = idx % depth;
      ring[slot] = img;
      status[slot] = rc;
      cv_consume.notify_all();
    }
  }

  int32_t next(O3RImage* out) {
    std::unique_lock<std::mutex> lk(mu);
    if (next_out >= paths.size()) return 1;  // exhausted
    size_t slot = next_out % depth;
    cv_consume.wait(lk, [&] { return status[slot] != kEmpty; });
    int32_t rc = status[slot];
    *out = ring[slot];
    ring[slot].data = nullptr;
    status[slot] = kEmpty;
    ++next_out;
    cv_produce.notify_all();
    return rc;
  }

  ~Prefetcher() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
    }
    cv_produce.notify_all();
    for (auto& w : workers) w.join();
    for (auto& im : ring)
      if (im.data) std::free(im.data);
  }
};

void* o3r_prefetch_create(const char** paths, int32_t n, int32_t depth,
                          int32_t n_threads) {
  if (n <= 0 || depth <= 0) return nullptr;
  return new Prefetcher(paths, n, depth, n_threads);
}

// Returns 0 ok (out filled, caller frees via o3r_image_free), 1 exhausted,
// negative: decode error for this frame (out undefined).
int32_t o3r_prefetch_next(void* handle, O3RImage* out) {
  return static_cast<Prefetcher*>(handle)->next(out);
}

void o3r_prefetch_destroy(void* handle) {
  delete static_cast<Prefetcher*>(handle);
}

int32_t o3r_version() { return 1; }

}  // extern "C"
