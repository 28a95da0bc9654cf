// The port's native JPEG pipeline for MODEL.IMAGE_LOADER: native.
//
// libjpeg decode, optional bounding-box crop, bilinear resize to a
// pre-size, second crop, horizontal flip, then for each output size a
// bilinear resize and the [-1, 1] float32 normalization, written HWC.  The
// resampler is plain align-corners=false sampling, not PIL's antialias
// filter, so items differ from the PIL path by a resampling error (the PIL
// path stays the parity path).  The ABI and the arithmetic are those of the
// JAX package's copy of this pipeline, so both give the same bits.
//
// Build: g++ -O3 -shared -fPIC -o libsba_loader.so sba_loader.cpp -ljpeg
// (sba_gan_tpu_torch/data/native_loader.py does it at first use).
//
// ABI (all C, error codes: 0 ok, <0 failure):
//   sba_load_image(path, bbox(4)|NULL, pre_w, pre_h, crop2(4)|NULL, hflip,
//                  sizes, n_sizes, outs[n_sizes])
//     decode -> optional bbox crop -> optional resize to (pre_w, pre_h)
//     -> optional second crop -> optional horizontal flip
//     -> for each size S: bilinear resize to SxS, normalize to [-1,1],
//        write HWC float32 into outs[i].
//   sba_loader_version() -> 1

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <algorithm>
#include <cmath>
#include <csetjmp>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jump, 1);
}

// Decode a JPEG file to an RGB8 buffer.  Returns 0 on success.
int decode_jpeg(const char* path, std::vector<unsigned char>& rgb, int* w,
                int* h) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return -2;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *w = cinfo.output_width;
  *h = cinfo.output_height;
  rgb.resize(size_t(*w) * *h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    unsigned char* row = rgb.data() + size_t(cinfo.output_scanline) * *w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  return 0;
}

// Bilinear resize RGB8 -> RGB8 (align_corners=false, pixel-center sampling).
void resize_bilinear(const unsigned char* src, int sw, int sh,
                     unsigned char* dst, int dw, int dh) {
  const float sx = float(sw) / dw;
  const float sy = float(sh) / dh;
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = int(std::floor(fy));
    float wy = fy - y0;
    int y1 = std::min(y0 + 1, sh - 1);
    y0 = std::max(y0, 0);
    for (int x = 0; x < dw; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      int x0 = int(std::floor(fx));
      float wx = fx - x0;
      int x1 = std::min(x0 + 1, sw - 1);
      x0 = std::max(x0, 0);
      for (int c = 0; c < 3; ++c) {
        float tl = src[(size_t(y0) * sw + x0) * 3 + c];
        float tr = src[(size_t(y0) * sw + x1) * 3 + c];
        float bl = src[(size_t(y1) * sw + x0) * 3 + c];
        float br = src[(size_t(y1) * sw + x1) * 3 + c];
        float top = tl + (tr - tl) * wx;
        float bot = bl + (br - bl) * wx;
        dst[(size_t(y) * dw + x) * 3 + c] =
            (unsigned char)std::lround(std::min(255.f, std::max(0.f, top + (bot - top) * wy)));
      }
    }
  }
}

void crop_rgb(std::vector<unsigned char>& img, int& w, int& h, int x0, int y0,
              int cw, int ch) {
  x0 = std::max(0, std::min(x0, w - 1));
  y0 = std::max(0, std::min(y0, h - 1));
  cw = std::min(cw, w - x0);
  ch = std::min(ch, h - y0);
  std::vector<unsigned char> out(size_t(cw) * ch * 3);
  for (int y = 0; y < ch; ++y)
    std::memcpy(out.data() + size_t(y) * cw * 3,
                img.data() + (size_t(y + y0) * w + x0) * 3, size_t(cw) * 3);
  img.swap(out);
  w = cw;
  h = ch;
}

void hflip_rgb(std::vector<unsigned char>& img, int w, int h) {
  for (int y = 0; y < h; ++y) {
    unsigned char* row = img.data() + size_t(y) * w * 3;
    for (int x = 0; x < w / 2; ++x)
      for (int c = 0; c < 3; ++c)
        std::swap(row[x * 3 + c], row[(w - 1 - x) * 3 + c]);
  }
}

}  // namespace

extern "C" {

int sba_load_image(const char* path, const int* bbox, int pre_w, int pre_h,
                   const int* crop2, int hflip, const int* sizes, int n_sizes,
                   float** outs) {
  std::vector<unsigned char> img;
  int w = 0, h = 0;
  int rc = decode_jpeg(path, img, &w, &h);
  if (rc != 0) return rc;

  if (bbox) crop_rgb(img, w, h, bbox[0], bbox[1], bbox[2], bbox[3]);

  if (pre_w > 0 && pre_h > 0 && (pre_w != w || pre_h != h)) {
    std::vector<unsigned char> resized(size_t(pre_w) * pre_h * 3);
    resize_bilinear(img.data(), w, h, resized.data(), pre_w, pre_h);
    img.swap(resized);
    w = pre_w;
    h = pre_h;
  }

  if (crop2) crop_rgb(img, w, h, crop2[0], crop2[1], crop2[2], crop2[3]);
  if (hflip) hflip_rgb(img, w, h);

  std::vector<unsigned char> scaled;
  for (int i = 0; i < n_sizes; ++i) {
    const int s = sizes[i];
    const unsigned char* src = img.data();
    int sw = w, sh = h;
    if (s != w || s != h) {
      scaled.assign(size_t(s) * s * 3, 0);
      resize_bilinear(img.data(), w, h, scaled.data(), s, s);
      src = scaled.data();
      sw = sh = s;
    }
    float* out = outs[i];
    const size_t n = size_t(sw) * sh * 3;
    for (size_t j = 0; j < n; ++j) out[j] = src[j] / 127.5f - 1.0f;
  }
  return 0;
}

int sba_loader_version() { return 1; }

}  // extern "C"
