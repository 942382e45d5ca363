// Native data loader of the port: threaded JPEG decode + bilinear resize
// to float32 RGB (a copy of ppn_tpu/native/loader.cc; the code below is
// unchanged, so both builds give the same pixels with the same flags).
//
// Host code, no kernel: a C++ worker pool decodes and resizes off the GIL
// inside the host process, feeding fixed-shape float32 arrays to the
// dataset loaders and the video directory source.
//
// C ABI (ctypes-friendly), no Python dependencies:
//   ppn_jpeg_dims(...)                 header-only original size
//   ppn_decode_resize(...)             one-shot synchronous decode+resize
//   ppn_loader_create/submit/get/...   asynchronous pool
//
// Build (ppn_tpu_torch/native/loader.py, at first use): g++ -O3
// -march=native -fPIC -std=c++17 -Wall against the ABI-62 headers in
// include/ and the libjpeg-turbo that the imported Pillow wheel ships in
// its pillow.libs directory.

#include <cstdio>  // jpeglib.h needs FILE declared first

#include <jpeglib.h>

#include <condition_variable>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <thread>
#include <vector>

namespace {

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jmp;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jmp, 1);
}

// Decode a JPEG byte buffer to RGB8. Returns false on corrupt input.
bool decode_jpeg(const uint8_t* data, size_t len, std::vector<uint8_t>* out,
                 int* w, int* h) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jmp)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data),
               static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *w = cinfo.output_width;
  *h = cinfo.output_height;
  out->resize(static_cast<size_t>(*w) * *h * 3);
  const int stride = *w * 3;
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->data() + static_cast<size_t>(cinfo.output_scanline) *
                                     stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// Bilinear resize RGB8 (h0,w0) → float32 [0,1] (H,W), align_corners=false
// (half-pixel centers; PIL's BILINEAR area-filters on a downscale and
// differs there).
void resize_bilinear(const uint8_t* src, int w0, int h0, float* dst, int W,
                     int H) {
  const float sx = static_cast<float>(w0) / W;
  const float sy = static_cast<float>(h0) / H;
  for (int y = 0; y < H; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = static_cast<int>(fy >= 0 ? fy : fy - 1);  // floor
    float wy = fy - y0;
    int y0c = y0 < 0 ? 0 : (y0 > h0 - 1 ? h0 - 1 : y0);
    int y1c = y0 + 1 < 0 ? 0 : (y0 + 1 > h0 - 1 ? h0 - 1 : y0 + 1);
    for (int x = 0; x < W; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      int x0 = static_cast<int>(fx >= 0 ? fx : fx - 1);
      float wx = fx - x0;
      int x0c = x0 < 0 ? 0 : (x0 > w0 - 1 ? w0 - 1 : x0);
      int x1c = x0 + 1 < 0 ? 0 : (x0 + 1 > w0 - 1 ? w0 - 1 : x0 + 1);
      const uint8_t* p00 = src + (static_cast<size_t>(y0c) * w0 + x0c) * 3;
      const uint8_t* p01 = src + (static_cast<size_t>(y0c) * w0 + x1c) * 3;
      const uint8_t* p10 = src + (static_cast<size_t>(y1c) * w0 + x0c) * 3;
      const uint8_t* p11 = src + (static_cast<size_t>(y1c) * w0 + x1c) * 3;
      float* o = dst + (static_cast<size_t>(y) * W + x) * 3;
      for (int c = 0; c < 3; ++c) {
        float top = p00[c] * (1 - wx) + p01[c] * wx;
        float bot = p10[c] * (1 - wx) + p11[c] * wx;
        o[c] = (top * (1 - wy) + bot * wy) * (1.0f / 255.0f);
      }
    }
  }
}

struct Job {
  int64_t id;
  std::vector<uint8_t> jpeg;
};

struct Result {
  int64_t id;
  bool ok;
  std::vector<float> pixels;
};

struct Loader {
  int out_h, out_w;
  std::vector<std::thread> workers;
  std::deque<Job> jobs;
  std::deque<Result> results;
  std::mutex mu;
  std::condition_variable job_cv, res_cv;
  bool stopping = false;

  Loader(int num_workers, int H, int W) : out_h(H), out_w(W) {
    for (int i = 0; i < num_workers; ++i)
      workers.emplace_back([this] { worker(); });
  }

  void worker() {
    std::vector<uint8_t> rgb;
    for (;;) {
      Job job;
      {
        std::unique_lock<std::mutex> lk(mu);
        job_cv.wait(lk, [this] { return stopping || !jobs.empty(); });
        if (stopping && jobs.empty()) return;
        job = std::move(jobs.front());
        jobs.pop_front();
      }
      Result res;
      res.id = job.id;
      int w0 = 0, h0 = 0;
      res.ok = decode_jpeg(job.jpeg.data(), job.jpeg.size(), &rgb, &w0, &h0);
      if (res.ok) {
        res.pixels.resize(static_cast<size_t>(out_h) * out_w * 3);
        resize_bilinear(rgb.data(), w0, h0, res.pixels.data(), out_w, out_h);
      }
      {
        std::lock_guard<std::mutex> lk(mu);
        results.push_back(std::move(res));
      }
      res_cv.notify_one();
    }
  }

  ~Loader() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stopping = true;
    }
    job_cv.notify_all();
    for (auto& t : workers) t.join();
  }
};

}  // namespace

extern "C" {

// Header-only probe: original (width, height) without a full decode.
// Returns 0 on success, -1 on a corrupt/non-JPEG buffer. Needed by
// dataset loaders whose GT coordinates must be rescaled by the original
// image size before the resized pixels come back.
int ppn_jpeg_dims(const uint8_t* jpeg, int64_t len, int* w, int* h) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jmp)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(jpeg),
               static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  *w = cinfo.image_width;
  *h = cinfo.image_height;
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// One-shot: decode+resize into caller-provided (H*W*3) float32 buffer.
// Returns 0 on success, -1 on decode failure.
int ppn_decode_resize(const uint8_t* jpeg, int64_t len, int out_h, int out_w,
                      float* out) {
  std::vector<uint8_t> rgb;
  int w0 = 0, h0 = 0;
  if (!decode_jpeg(jpeg, static_cast<size_t>(len), &rgb, &w0, &h0)) return -1;
  resize_bilinear(rgb.data(), w0, h0, out, out_w, out_h);
  return 0;
}

void* ppn_loader_create(int num_workers, int out_h, int out_w) {
  return new Loader(num_workers, out_h, out_w);
}

void ppn_loader_submit(void* handle, int64_t id, const uint8_t* jpeg,
                       int64_t len) {
  auto* loader = static_cast<Loader*>(handle);
  Job job;
  job.id = id;
  job.jpeg.assign(jpeg, jpeg + len);
  {
    std::lock_guard<std::mutex> lk(loader->mu);
    loader->jobs.push_back(std::move(job));
  }
  loader->job_cv.notify_one();
}

// Blocking pop. Writes the frame into `out` (out_h*out_w*3 floats).
// Returns the job id, or -1 if the decode failed (id in *failed_id).
int64_t ppn_loader_get(void* handle, float* out) {
  auto* loader = static_cast<Loader*>(handle);
  Result res;
  {
    std::unique_lock<std::mutex> lk(loader->mu);
    loader->res_cv.wait(lk, [loader] { return !loader->results.empty(); });
    res = std::move(loader->results.front());
    loader->results.pop_front();
  }
  if (!res.ok) return -(res.id + 2);  // encode failure as -(id+2)
  std::memcpy(out, res.pixels.data(), res.pixels.size() * sizeof(float));
  return res.id;
}

int ppn_loader_pending(void* handle) {
  auto* loader = static_cast<Loader*>(handle);
  std::lock_guard<std::mutex> lk(loader->mu);
  return static_cast<int>(loader->jobs.size() + loader->results.size());
}

void ppn_loader_destroy(void* handle) {
  delete static_cast<Loader*>(handle);
}

}  // extern "C"
