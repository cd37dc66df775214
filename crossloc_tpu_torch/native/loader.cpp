// Host-side image decoder of the PyTorch port: PNG and JPEG decode, then a
// resize to the requested size, emitting float32 RGB in [0, 1]; or, where
// the stored size is the requested one, the decoded RGB bytes as they are.
//
// The port's data layer (crossloc_tpu_torch/data/dataset.py) decodes every
// training and evaluation image on the host, in a thread pool. A ctypes call
// into this library releases the interpreter lock for its whole length, so
// the pool's threads decode in parallel; PIL holds the lock for part of
// each call. Gray, gray + alpha, RGBA and palette images become RGB; 16-bit
// samples keep their high byte. Without a resize the output is exactly
// byte / 255, the same bits as the PIL path for 8-bit images.
//
// PNG is decoded here on zlib alone (chunks, inflate, the five row filters),
// so the library needs no libpng; an interlaced PNG returns failure and the
// caller decodes it with PIL. JPEG goes through libjpeg when the build
// defines CL_WITH_JPEG; without it a JPEG returns failure the same way.
//
// C ABI (no Python headers): cl_image_dims reads only the header;
// cl_load_image decodes and resizes; cl_load_image_u8 decodes and refuses a
// resize. All return 0 on success, -1 on failure.
// Built at first use by crossloc_tpu_torch/native/__init__.py with
// g++ -O3 -fPIC -shared, linked against zlib (and libjpeg).

#include <zlib.h>

#include <algorithm>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#ifdef CL_WITH_JPEG
#include <jpeglib.h>  // after <cstdio>: it uses FILE unqualified
#endif

namespace {

struct Image {
  int w = 0, h = 0;
  std::vector<uint8_t> rgb;  // h * w * 3
};

bool has_suffix(const std::string& s, const char* suf) {
  std::string l = s;
  std::transform(l.begin(), l.end(), l.begin(), ::tolower);
  std::string t(suf);
  return l.size() >= t.size() && l.compare(l.size() - t.size(), t.size(), t) == 0;
}

// ---- PNG on zlib -----------------------------------------------------------

const uint8_t kPngSig[8] = {137, 80, 78, 71, 13, 10, 26, 10};

uint32_t be32(const uint8_t* p) {
  return (uint32_t)p[0] << 24 | (uint32_t)p[1] << 16 | (uint32_t)p[2] << 8 | p[3];
}

bool read_file(const char* path, std::vector<uint8_t>* buf) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return false;
  bool ok = fseek(fp, 0, SEEK_END) == 0;
  long n = ok ? ftell(fp) : -1;
  ok = ok && n > 0 && fseek(fp, 0, SEEK_SET) == 0;
  if (ok) {
    buf->resize((size_t)n);
    ok = fread(buf->data(), 1, (size_t)n, fp) == (size_t)n;
  }
  fclose(fp);
  return ok;
}

struct PngHeader {
  uint32_t w = 0, h = 0;
  int depth = 0, ctype = 0, interlace = 0;
};

int png_channels(int ctype) {
  switch (ctype) {
    case 0: return 1;  // gray
    case 2: return 3;  // RGB
    case 3: return 1;  // palette index
    case 4: return 2;  // gray + alpha
    case 6: return 4;  // RGBA
  }
  return 0;
}

// The largest image decoded here: 2^28 pixels (16384 x 16384). The sizes of
// the buffers come from the file's header, so a header past this is refused
// before anything is allocated: the inflate buffer of a 16-bit RGBA image of
// this size, h * (8 w + 1) bytes, stays below 2^32, the limit of zlib's uInt.
constexpr uint64_t kMaxPixels = uint64_t(1) << 28;

bool pixels_ok(uint64_t w, uint64_t h) { return w > 0 && h > 0 && w * h <= kMaxPixels; }

// IHDR at its fixed place after the signature; the field combinations the
// PNG specification allows.
bool png_header(const uint8_t* p, size_t n, PngHeader* hd) {
  if (n < 33 || memcmp(p, kPngSig, 8) != 0 || be32(p + 8) != 13 || memcmp(p + 12, "IHDR", 4))
    return false;
  const uint8_t* d = p + 16;
  hd->w = be32(d);
  hd->h = be32(d + 4);
  hd->depth = d[8];
  hd->ctype = d[9];
  hd->interlace = d[12];
  const int dp = hd->depth;
  bool ok;
  switch (hd->ctype) {
    case 0: ok = dp == 1 || dp == 2 || dp == 4 || dp == 8 || dp == 16; break;
    case 3: ok = dp == 1 || dp == 2 || dp == 4 || dp == 8; break;
    case 2: case 4: case 6: ok = dp == 8 || dp == 16; break;
    default: ok = false;
  }
  return ok && hd->w > 0 && hd->h > 0 && pixels_ok(hd->w, hd->h) && d[10] == 0 && d[11] == 0 &&
         hd->interlace <= 1;
}

uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return (uint8_t)a;
  return (uint8_t)(pb <= pc ? b : c);
}

// Undo the row filters in place: raw holds h rows of (1 filter byte + stride).
// The first row's "previous row" is zeros.
bool unfilter(std::vector<uint8_t>* raw, size_t h, size_t stride, size_t bpp) {
  const std::vector<uint8_t> zeros(stride, 0);
  const uint8_t* prev = zeros.data();
  for (size_t y = 0; y < h; y++) {
    uint8_t* row = raw->data() + y * (stride + 1);
    const int f = row[0];
    uint8_t* r = row + 1;
    const size_t lead = std::min(bpp, stride);  // bytes with no left neighbour
    switch (f) {
      case 0: break;
      case 1:
        for (size_t i = bpp; i < stride; i++) r[i] += r[i - bpp];
        break;
      case 2:
        for (size_t i = 0; i < stride; i++) r[i] += prev[i];
        break;
      case 3:
        for (size_t i = 0; i < lead; i++) r[i] += prev[i] >> 1;
        for (size_t i = bpp; i < stride; i++) r[i] += (uint8_t)((r[i - bpp] + prev[i]) >> 1);
        break;
      case 4:
        for (size_t i = 0; i < lead; i++) r[i] += prev[i];  // paeth(0, b, 0) = b
        for (size_t i = bpp; i < stride; i++) r[i] += paeth(r[i - bpp], prev[i], prev[i - bpp]);
        break;
      default: return false;
    }
    prev = r;
  }
  return true;
}

bool png_dims(const char* path, int* h, int* w) {
  uint8_t head[33];
  FILE* fp = fopen(path, "rb");
  if (!fp) return false;
  const size_t n = fread(head, 1, sizeof(head), fp);
  fclose(fp);
  PngHeader hd;
  if (!png_header(head, n, &hd)) return false;
  *h = (int)hd.h;
  *w = (int)hd.w;
  return true;
}

bool decode_png(const char* path, Image* out) {
  std::vector<uint8_t> file;
  PngHeader hd;
  if (!read_file(path, &file) || !png_header(file.data(), file.size(), &hd)) return false;
  if (hd.interlace != 0) return false;  // Adam7: left to the caller's fallback
  uint8_t palette[256][3] = {};  // entries past the PLTE chunk stay black, as in libpng
  std::vector<std::pair<const uint8_t*, uint32_t>> idat;  // the IDAT payloads, in order
  bool seen_end = false;
  for (size_t pos = 8; pos + 12 <= file.size();) {
    const uint32_t len = be32(&file[pos]);
    if (len > file.size() - pos - 12) return false;
    const uint8_t* type = &file[pos + 4];
    const uint8_t* data = type + 4;
    const bool critical = !(type[0] & 0x20);
    if (critical && crc32(crc32(0L, Z_NULL, 0), type, len + 4) != be32(data + len)) return false;
    if (!memcmp(type, "PLTE", 4)) {
      if (len % 3 || len > 768) return false;
      memcpy(palette, data, len);
    } else if (!memcmp(type, "IDAT", 4)) {
      idat.emplace_back(data, len);
    } else if (!memcmp(type, "IEND", 4)) {
      seen_end = true;
      break;
    }
    pos += 12 + (size_t)len;
  }
  if (!seen_end || idat.empty()) return false;

  const size_t w = hd.w, h = hd.h;
  const int ch = png_channels(hd.ctype);
  const size_t stride = (w * ch * hd.depth + 7) / 8;
  const size_t bpp = std::max<size_t>(1, (size_t)ch * hd.depth / 8);
  std::vector<uint8_t> raw(h * (stride + 1));
  z_stream zs = {};
  if (inflateInit(&zs) != Z_OK) return false;
  zs.next_out = raw.data();
  zs.avail_out = (uInt)raw.size();
  int zrc = Z_OK;
  for (size_t i = 0; i < idat.size() && zrc == Z_OK && zs.avail_out > 0; i++) {
    zs.next_in = const_cast<uint8_t*>(idat[i].first);
    zs.avail_in = idat[i].second;
    zrc = inflate(&zs, Z_NO_FLUSH);
  }
  const bool full = zs.avail_out == 0;
  inflateEnd(&zs);
  if (!full || (zrc != Z_OK && zrc != Z_STREAM_END && zrc != Z_BUF_ERROR)) return false;
  if (!unfilter(&raw, h, stride, bpp)) return false;

  out->w = (int)w;
  out->h = (int)h;
  out->rgb.resize(w * h * 3);
  const int depth = hd.depth;
  const int step = depth == 16 ? 2 : 1;  // 16-bit samples: the high byte
  for (size_t y = 0; y < h; y++) {
    const uint8_t* r = raw.data() + y * (stride + 1) + 1;
    uint8_t* o = out->rgb.data() + y * w * 3;
    if (depth < 8) {  // gray or palette, packed MSB first
      const int per = 8 / depth, mask = (1 << depth) - 1;
      const int scale = hd.ctype == 0 ? 255 / mask : 1;  // gray: 1, 2, 4 bits to 8
      for (size_t x = 0; x < w; x++) {
        const int v = (r[x / per] >> ((per - 1 - (int)(x % per)) * depth)) & mask;
        if (hd.ctype == 3) {
          memcpy(o + 3 * x, palette[v], 3);
        } else {
          o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = (uint8_t)(v * scale);
        }
      }
      continue;
    }
    if (hd.ctype == 2 && depth == 8) {
      memcpy(o, r, w * 3);
      continue;
    }
    for (size_t x = 0; x < w; x++) {
      const uint8_t* px = r + x * ch * step;
      switch (hd.ctype) {
        case 0: case 4:
          o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = px[0];
          break;
        case 3:
          memcpy(o + 3 * x, palette[px[0]], 3);
          break;
        default:  // 2, 6
          o[3 * x] = px[0];
          o[3 * x + 1] = px[step];
          o[3 * x + 2] = px[2 * step];
      }
    }
  }
  return true;
}

// ---- JPEG on libjpeg -------------------------------------------------------

#ifdef CL_WITH_JPEG
struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* e = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(e->jb, 1);
}

bool decode_jpeg(const char* path, Image* out) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return false;
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(fp);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, fp);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  if (!pixels_ok(cinfo.output_width, cinfo.output_height)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(fp);
    return false;
  }
  out->w = cinfo.output_width;
  out->h = cinfo.output_height;
  out->rgb.resize((size_t)out->w * out->h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->rgb.data() + (size_t)cinfo.output_scanline * out->w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(fp);
  return true;
}

bool jpeg_dims(const char* path, int* h, int* w) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return false;
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(fp);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, fp);
  jpeg_read_header(&cinfo, TRUE);
  *w = (int)cinfo.image_width;
  *h = (int)cinfo.image_height;
  jpeg_destroy_decompress(&cinfo);
  fclose(fp);
  return pixels_ok(*w, *h);
}

#else
bool decode_jpeg(const char*, Image*) { return false; }
bool jpeg_dims(const char*, int*, int*) { return false; }
#endif  // CL_WITH_JPEG

bool decode_any(const char* path, Image* out) {
  std::string p(path);
  if (has_suffix(p, ".png")) return decode_png(path, out);
  if (has_suffix(p, ".jpg") || has_suffix(p, ".jpeg")) return decode_jpeg(path, out);
  // try both on unknown extensions
  return decode_png(path, out) || decode_jpeg(path, out);
}

// Separable triangle-filter resampling with half-pixel centers and
// antialiasing on downscale — the algorithm PIL's BILINEAR resize uses,
// which is what the reference host pipeline runs (torchvision Resize ->
// PIL, `dataloader/dataloader.py:172-211`).
struct FilterTaps {
  std::vector<int> start;     // first source index per output index
  std::vector<int> count;     // taps per output index
  std::vector<float> weight;  // flattened [out, max_count] weights
  int max_count = 0;
};

FilterTaps make_taps(int in_size, int out_size) {
  FilterTaps t;
  const double scale = (double)in_size / out_size;
  const double fscale = std::max(scale, 1.0);
  const double support = 1.0 * fscale;  // triangle filter support
  t.max_count = (int)std::ceil(2.0 * support) + 2;
  t.start.resize(out_size);
  t.count.resize(out_size);
  t.weight.assign((size_t)out_size * t.max_count, 0.0f);
  for (int o = 0; o < out_size; o++) {
    const double center = (o + 0.5) * scale;
    int lo = std::max(0, (int)(center - support + 0.5));
    int hi = std::min(in_size, (int)(center + support + 0.5));
    double sum = 0.0;
    for (int i = lo; i < hi; i++) {
      double u = std::abs((i + 0.5 - center) / fscale);
      double w = u < 1.0 ? 1.0 - u : 0.0;
      t.weight[(size_t)o * t.max_count + (i - lo)] = (float)w;
      sum += w;
    }
    if (sum <= 0.0) {  // degenerate: nearest
      lo = std::min(std::max((int)center, 0), in_size - 1);
      hi = lo + 1;
      t.weight[(size_t)o * t.max_count] = 1.0f;
      sum = 1.0;
    }
    for (int k = 0; k < hi - lo; k++)
      t.weight[(size_t)o * t.max_count + k] /= (float)sum;
    t.start[o] = lo;
    t.count[o] = hi - lo;
  }
  return t;
}

void resize_bilinear_f32(const Image& img, int th, int tw, float* out) {
  const FilterTaps ty = make_taps(img.h, th);
  const FilterTaps tx = make_taps(img.w, tw);
  // horizontal pass: [h, w, 3] -> [h, tw, 3]
  std::vector<float> tmp((size_t)img.h * tw * 3);
  for (int y = 0; y < img.h; y++) {
    const uint8_t* row = img.rgb.data() + (size_t)y * img.w * 3;
    for (int x = 0; x < tw; x++) {
      const float* wts = tx.weight.data() + (size_t)x * tx.max_count;
      float acc[3] = {0, 0, 0};
      for (int k = 0; k < tx.count[x]; k++) {
        const uint8_t* px = row + (size_t)(tx.start[x] + k) * 3;
        acc[0] += wts[k] * px[0];
        acc[1] += wts[k] * px[1];
        acc[2] += wts[k] * px[2];
      }
      float* dst = tmp.data() + ((size_t)y * tw + x) * 3;
      dst[0] = acc[0];
      dst[1] = acc[1];
      dst[2] = acc[2];
    }
  }
  // vertical pass: [h, tw, 3] -> [th, tw, 3], scaled to [0, 1]
  for (int y = 0; y < th; y++) {
    const float* wts = ty.weight.data() + (size_t)y * ty.max_count;
    for (int x = 0; x < tw; x++) {
      float acc[3] = {0, 0, 0};
      for (int k = 0; k < ty.count[y]; k++) {
        const float* px = tmp.data() + ((size_t)(ty.start[y] + k) * tw + x) * 3;
        acc[0] += wts[k] * px[0];
        acc[1] += wts[k] * px[1];
        acc[2] += wts[k] * px[2];
      }
      float* dst = out + ((size_t)y * tw + x) * 3;
      dst[0] = acc[0] / 255.0f;
      dst[1] = acc[1] / 255.0f;
      dst[2] = acc[2] / 255.0f;
    }
  }
}

}  // namespace

extern "C" {

// No exception leaves these functions: one that reached the caller through
// the C ABI would end the process. An allocation that fails returns -1.

// Returns 0 on success and fills (*h, *w) with the stored image size.
// Header-only: does NOT decode the bitstream.
int cl_image_dims(const char* path, int* h, int* w) {
  try {
    std::string p(path);
    if (has_suffix(p, ".png")) return png_dims(path, h, w) ? 0 : -1;
    if (has_suffix(p, ".jpg") || has_suffix(p, ".jpeg"))
      return jpeg_dims(path, h, w) ? 0 : -1;
    return (png_dims(path, h, w) || jpeg_dims(path, h, w)) ? 0 : -1;
  } catch (...) {
    return -1;
  }
}

// Decode + resize to exactly (th, tw); out must hold th*tw*3 floats.
// Returns 0 on success.
int cl_load_image(const char* path, int th, int tw, float* out) {
  try {
    if (th <= 0 || tw <= 0 || !pixels_ok(tw, th)) return -1;
    Image img;
    if (!decode_any(path, &img)) return -1;
    if (img.h == th && img.w == tw) {
      const size_t n = (size_t)th * tw * 3;
      for (size_t i = 0; i < n; i++) out[i] = img.rgb[i] / 255.0f;
      return 0;
    }
    resize_bilinear_f32(img, th, tw, out);
    return 0;
  } catch (...) {
    return -1;
  }
}

// Decode to exactly (th, tw) uint8 RGB, the decoded bytes unchanged (the
// bytes cl_load_image divides by 255 when it does not resize); out must hold
// th*tw*3 bytes. Returns -1, writing nothing, where the stored size is not
// (th, tw): this entry never resizes.
int cl_load_image_u8(const char* path, int th, int tw, uint8_t* out) {
  try {
    if (th <= 0 || tw <= 0 || !pixels_ok(tw, th)) return -1;
    Image img;
    if (!decode_any(path, &img)) return -1;
    if (img.h != th || img.w != tw) return -1;
    std::memcpy(out, img.rgb.data(), (size_t)th * tw * 3);
    return 0;
  } catch (...) {
    return -1;
  }
}

}  // extern "C"
