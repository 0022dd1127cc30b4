// Native RGB-D frame loader: image decode + multithreaded prefetch.
//
// The reference does synchronous per-frame decode on the compute thread via
// the Rust `image` crate (src/io/dataset/*.rs). The host must keep the
// device fed, so this library provides:
//   * PNG 16-bit grayscale decode (depth maps)  -> a3d_decode_depth_png
//   * PNG/JPEG 8-bit RGB decode (color frames)  -> a3d_decode_rgb
//   * a prefetching loader: a worker pool decodes frames ahead of the
//     consumer into a bounded ring of slots -> a3d_loader_* API
//
// Pure C ABI (consumed from Python with ctypes — no pybind11 dependency).
// Build: make -C native  (links libpng, libjpeg, pthread).

#include <png.h>

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <csetjmp>

#include <condition_variable>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

extern "C" {
#include <jpeglib.h>
}

namespace {

struct Image {
  int width = 0;
  int height = 0;
  int channels = 0;      // 1 or 3
  int bit_depth = 0;     // 8 or 16
  std::vector<uint8_t> data;  // row-major, native endianness for 16-bit
  bool ok = false;
  std::string error;
};

bool has_suffix(const std::string& s, const char* suffix) {
  size_t n = strlen(suffix);
  if (s.size() < n) return false;
  for (size_t i = 0; i < n; i++) {
    char a = s[s.size() - n + i];
    char b = suffix[i];
    if (tolower(a) != tolower(b)) return false;
  }
  return true;
}

Image decode_png(const char* path, bool want_rgb) {
  Image img;
  FILE* fp = fopen(path, "rb");
  if (!fp) {
    img.error = "cannot open file";
    return img;
  }
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png_create_info_struct(png);
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(fp);
    img.error = "png decode error";
    img.ok = false;
    return img;
  }
  png_init_io(png, fp);
  png_read_info(png, info);

  png_uint_32 w = png_get_image_width(png, info);
  png_uint_32 h = png_get_image_height(png, info);
  int bit_depth = png_get_bit_depth(png, info);
  int color_type = png_get_color_type(png, info);

  if (want_rgb) {
    if (bit_depth == 16) png_set_strip_16(png);
    if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
    if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8)
      png_set_expand_gray_1_2_4_to_8(png);
    if (color_type == PNG_COLOR_TYPE_GRAY ||
        color_type == PNG_COLOR_TYPE_GRAY_ALPHA)
      png_set_gray_to_rgb(png);
    if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
    png_set_strip_alpha(png);
    img.channels = 3;
    img.bit_depth = 8;
  } else {
    // Depth: expect 16-bit grayscale; PNG stores big-endian -> swap.
    if (bit_depth == 16) png_set_swap(png);
    img.channels = 1;
    img.bit_depth = bit_depth;
  }
  png_read_update_info(png, info);

  size_t rowbytes = png_get_rowbytes(png, info);
  img.width = (int)w;
  img.height = (int)h;
  img.data.resize(rowbytes * h);
  std::vector<png_bytep> rows(h);
  for (png_uint_32 r = 0; r < h; r++) rows[r] = img.data.data() + r * rowbytes;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  fclose(fp);
  img.ok = true;
  return img;
}

struct JpegErrorMgr {
  jpeg_error_mgr pub_;
  jmp_buf setjmp_buffer;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  JpegErrorMgr* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

Image decode_jpeg(const char* path) {
  Image img;
  FILE* fp = fopen(path, "rb");
  if (!fp) {
    img.error = "cannot open file";
    return img;
  }
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub_);
  jerr.pub_.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(fp);
    img.error = "jpeg decode error";
    img.ok = false;
    return img;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, fp);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  img.width = cinfo.output_width;
  img.height = cinfo.output_height;
  img.channels = 3;
  img.bit_depth = 8;
  img.data.resize((size_t)img.width * img.height * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = img.data.data() + (size_t)cinfo.output_scanline * img.width * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(fp);
  img.ok = true;
  return img;
}

Image decode_any_rgb(const char* path) {
  std::string p(path);
  if (has_suffix(p, ".jpg") || has_suffix(p, ".jpeg")) return decode_jpeg(path);
  return decode_png(path, /*want_rgb=*/true);
}

// ---------------- prefetching loader ----------------

struct Frame {
  Image color;
  Image depth;
  bool ready = false;
};

struct Loader {
  std::vector<std::string> color_paths;
  std::vector<std::string> depth_paths;
  std::unordered_map<int, Frame> cache;
  std::deque<int> pending;
  std::mutex mu;
  std::condition_variable cv_work;
  std::condition_variable cv_done;
  std::vector<std::thread> workers;
  size_t ahead = 8;
  int next_issue = 0;
  bool stop = false;

  void worker() {
    for (;;) {
      int idx;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_work.wait(lk, [&] { return stop || !pending.empty(); });
        if (stop) return;
        idx = pending.front();
        pending.pop_front();
      }
      Frame f;
      f.color = decode_any_rgb(color_paths[idx].c_str());
      f.depth = decode_png(depth_paths[idx].c_str(), /*want_rgb=*/false);
      f.ready = true;
      {
        std::lock_guard<std::mutex> lk(mu);
        cache[idx] = std::move(f);
      }
      cv_done.notify_all();
    }
  }

  void schedule_upto(int idx) {
    // caller holds mu
    int target = std::min((int)color_paths.size(), idx + (int)ahead);
    for (; next_issue < target; next_issue++) {
      pending.push_back(next_issue);
    }
    cv_work.notify_all();
  }
};

}  // namespace

extern "C" {

// -------- single-shot decode (caller frees with a3d_free) --------

// Returns 0 on success. Caller passes out pointers for dims; data is
// malloc'd: u8 RGB (h*w*3) for color, u16 (h*w) for depth.
int a3d_decode_rgb(const char* path, uint8_t** data, int* width, int* height) {
  Image img = decode_any_rgb(path);
  if (!img.ok) return 1;
  *data = (uint8_t*)malloc(img.data.size());
  memcpy(*data, img.data.data(), img.data.size());
  *width = img.width;
  *height = img.height;
  return 0;
}

int a3d_decode_depth_png(const char* path, uint16_t** data, int* width,
                         int* height) {
  Image img = decode_png(path, /*want_rgb=*/false);
  if (!img.ok) return 1;
  if (img.bit_depth == 16) {
    *data = (uint16_t*)malloc(img.data.size());
    memcpy(*data, img.data.data(), img.data.size());
  } else {  // widen 8 -> 16
    size_t n = (size_t)img.width * img.height;
    *data = (uint16_t*)malloc(n * 2);
    for (size_t i = 0; i < n; i++) (*data)[i] = img.data[i];
  }
  *width = img.width;
  *height = img.height;
  return 0;
}

void a3d_free(void* p) { free(p); }

// -------- prefetching loader --------

void* a3d_loader_create(const char** color_paths, const char** depth_paths,
                        int n_frames, int n_threads, int prefetch_ahead) {
  Loader* l = new Loader();
  l->color_paths.assign(color_paths, color_paths + n_frames);
  l->depth_paths.assign(depth_paths, depth_paths + n_frames);
  l->ahead = prefetch_ahead > 0 ? prefetch_ahead : 8;
  int nt = n_threads > 0 ? n_threads : 4;
  for (int i = 0; i < nt; i++)
    l->workers.emplace_back([l] { l->worker(); });
  {
    std::lock_guard<std::mutex> lk(l->mu);
    l->schedule_upto(0);
  }
  return l;
}

// Blocks until frame idx is decoded; copies into caller buffers (which must
// be large enough: color h*w*3 u8, depth h*w u16). Returns 0 on success,
// sets dims. Drops frames older than idx from the cache and schedules ahead.
int a3d_loader_get(void* handle, int idx, uint8_t* color_out, int color_cap,
                   uint16_t* depth_out, int depth_cap, int* cw, int* ch,
                   int* dw, int* dh) {
  Loader* l = (Loader*)handle;
  std::unique_lock<std::mutex> lk(l->mu);
  if (idx < 0 || idx >= (int)l->color_paths.size()) return 2;
  l->schedule_upto(idx);
  // If idx somehow wasn't issued (random access backwards), issue it now.
  if (l->cache.find(idx) == l->cache.end() && idx >= l->next_issue) {
    l->pending.push_front(idx);
    l->cv_work.notify_all();
  }
  bool issued = false;
  for (int p : l->pending)
    if (p == idx) issued = true;
  if (l->cache.find(idx) == l->cache.end() && !issued && idx < l->next_issue) {
    // evicted or never scheduled: re-issue
    l->pending.push_front(idx);
    l->cv_work.notify_all();
  }
  l->cv_done.wait(lk, [&] {
    auto it = l->cache.find(idx);
    return it != l->cache.end() && it->second.ready;
  });
  Frame& f = l->cache[idx];
  if (!f.color.ok || !f.depth.ok) return 1;
  int need_c = f.color.width * f.color.height * 3;
  int need_d = f.depth.width * f.depth.height;
  if (need_c > color_cap || need_d > depth_cap) return 3;
  memcpy(color_out, f.color.data.data(), need_c);
  memcpy(depth_out, f.depth.data.data(), (size_t)need_d * 2);
  *cw = f.color.width;
  *ch = f.color.height;
  *dw = f.depth.width;
  *dh = f.depth.height;
  // Evict everything up to idx (sequential consumption pattern).
  for (auto it = l->cache.begin(); it != l->cache.end();) {
    if (it->first <= idx)
      it = l->cache.erase(it);
    else
      ++it;
  }
  return 0;
}

void a3d_loader_destroy(void* handle) {
  Loader* l = (Loader*)handle;
  {
    std::lock_guard<std::mutex> lk(l->mu);
    l->stop = true;
  }
  l->cv_work.notify_all();
  for (auto& t : l->workers) t.join();
  delete l;
}

}  // extern "C"
