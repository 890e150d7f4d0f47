// Native JPEG decode + resize for the host data path of the PyTorch port
// (efficientvlm_tpu_torch/data/fastjpeg.py builds and loads it).
//
// Decodes with libjpeg's DCT-domain scaling (decode directly at 1/8..8/8 of
// full size, skipping most of the IDCT work) and finishes with a single-pass
// bilinear resize to the exact target, all in C++ without holding the GIL,
// so loader threads decode in parallel.
//
// Python surface:
//   _fastjpeg.decode_resize(data: bytes, out_h: int, out_w: int) -> bytes
//     RGB8, len == out_h*out_w*3; raises ValueError on corrupt input.
//   _fastjpeg.decode_dims(data: bytes) -> (h, w)

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <csetjmp>
#include <cstdio>
#include <cstring>
#include <vector>

#include <jpeglib.h>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  std::jmp_buf jmp;
  char msg[JMSG_LENGTH_MAX];
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  (*cinfo->err->format_message)(cinfo, err->msg);
  std::longjmp(err->jmp, 1);
}

// Bilinear resize RGB8 HWC -> RGB8 HWC (separable weights computed per row).
void resize_bilinear(const unsigned char* src, int sh, int sw,
                     unsigned char* dst, int dh, int dw) {
  if (sh == dh && sw == dw) {
    std::memcpy(dst, src, static_cast<size_t>(sh) * sw * 3);
    return;
  }
  const float ry = dh > 1 ? static_cast<float>(sh - 1) / (dh - 1) : 0.f;
  const float rx = dw > 1 ? static_cast<float>(sw - 1) / (dw - 1) : 0.f;
  std::vector<int> x0(dw), x1(dw);
  std::vector<float> wx(dw);
  for (int x = 0; x < dw; ++x) {
    float fx = rx * x;
    x0[x] = static_cast<int>(fx);
    x1[x] = x0[x] + 1 < sw ? x0[x] + 1 : sw - 1;
    wx[x] = fx - x0[x];
  }
  for (int y = 0; y < dh; ++y) {
    float fy = ry * y;
    int y0 = static_cast<int>(fy);
    int y1 = y0 + 1 < sh ? y0 + 1 : sh - 1;
    float dy = fy - y0;
    const unsigned char* r0 = src + static_cast<size_t>(y0) * sw * 3;
    const unsigned char* r1 = src + static_cast<size_t>(y1) * sw * 3;
    unsigned char* out = dst + static_cast<size_t>(y) * dw * 3;
    for (int x = 0; x < dw; ++x) {
      const unsigned char* p00 = r0 + x0[x] * 3;
      const unsigned char* p01 = r0 + x1[x] * 3;
      const unsigned char* p10 = r1 + x0[x] * 3;
      const unsigned char* p11 = r1 + x1[x] * 3;
      float w = wx[x];
      for (int c = 0; c < 3; ++c) {
        float top = p00[c] + (p01[c] - p00[c]) * w;
        float bot = p10[c] + (p11[c] - p10[c]) * w;
        float v = top + (bot - top) * dy;
        out[x * 3 + c] = static_cast<unsigned char>(v + 0.5f);
      }
    }
  }
}

// Decode `data` at the cheapest DCT scale >= (out_h, out_w), then bilinear
// to the exact target. Returns false on decode error (msg filled).
bool decode_resize_impl(const unsigned char* data, size_t len, int out_h,
                        int out_w, std::vector<unsigned char>* out, char* msg) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  // constructed BEFORE setjmp: a mid-decode longjmp (truncated/corrupt
  // JPEGs in a dirty pretrain stream) must not skip the destructor — the
  // error return path below then frees it like any normal exit
  std::vector<unsigned char> buf;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.jmp)) {
    std::snprintf(msg, JMSG_LENGTH_MAX, "%s", jerr.msg);
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(data), len);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;

  // largest M/8 (M=1..8) with scaled dims still >= target: the IDCT then
  // produces the smallest image that doesn't lose target resolution
  for (int m = 1; m <= 8; ++m) {
    cinfo.scale_num = m;
    cinfo.scale_denom = 8;
    long sh = (static_cast<long>(cinfo.image_height) * m + 7) / 8;
    long sw = (static_cast<long>(cinfo.image_width) * m + 7) / 8;
    if (sh >= out_h && sw >= out_w) break;
  }

  jpeg_start_decompress(&cinfo);
  int sh = cinfo.output_height, sw = cinfo.output_width;
  buf.resize(static_cast<size_t>(sh) * sw * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    unsigned char* row = buf.data() + static_cast<size_t>(cinfo.output_scanline) * sw * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);

  out->resize(static_cast<size_t>(out_h) * out_w * 3);
  resize_bilinear(buf.data(), sh, sw, out->data(), out_h, out_w);
  return true;
}

PyObject* decode_resize(PyObject*, PyObject* args) {
  Py_buffer view;
  int out_h, out_w;
  if (!PyArg_ParseTuple(args, "y*ii", &view, &out_h, &out_w)) return nullptr;
  if (out_h <= 0 || out_w <= 0) {
    PyBuffer_Release(&view);
    PyErr_SetString(PyExc_ValueError, "target dims must be positive");
    return nullptr;
  }
  std::vector<unsigned char> out;
  char msg[JMSG_LENGTH_MAX] = {0};
  bool ok;
  Py_BEGIN_ALLOW_THREADS
  ok = decode_resize_impl(static_cast<const unsigned char*>(view.buf),
                          static_cast<size_t>(view.len), out_h, out_w, &out, msg);
  Py_END_ALLOW_THREADS
  PyBuffer_Release(&view);
  if (!ok) {
    PyErr_Format(PyExc_ValueError, "jpeg decode failed: %s", msg);
    return nullptr;
  }
  return PyBytes_FromStringAndSize(reinterpret_cast<const char*>(out.data()),
                                   static_cast<Py_ssize_t>(out.size()));
}

PyObject* decode_dims(PyObject*, PyObject* args) {
  Py_buffer view;
  if (!PyArg_ParseTuple(args, "y*", &view)) return nullptr;
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.jmp)) {
    jpeg_destroy_decompress(&cinfo);
    PyBuffer_Release(&view);
    PyErr_Format(PyExc_ValueError, "jpeg header read failed: %s", jerr.msg);
    return nullptr;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, static_cast<unsigned char*>(view.buf),
               static_cast<size_t>(view.len));
  jpeg_read_header(&cinfo, TRUE);
  int h = cinfo.image_height, w = cinfo.image_width;
  jpeg_destroy_decompress(&cinfo);
  PyBuffer_Release(&view);
  return Py_BuildValue("(ii)", h, w);
}

PyMethodDef methods[] = {
    {"decode_resize", decode_resize, METH_VARARGS,
     "decode_resize(data, out_h, out_w) -> RGB8 bytes"},
    {"decode_dims", decode_dims, METH_VARARGS, "decode_dims(data) -> (h, w)"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef moduledef = {PyModuleDef_HEAD_INIT, "_fastjpeg",
                         "libjpeg DCT-scaled decode + bilinear resize",
                         -1, methods};

}  // namespace

PyMODINIT_FUNC PyInit__fastjpeg(void) { return PyModule_Create(&moduledef); }
