// CPython bindings of the kernel library's C entries.
//
// The library is loaded as an extension module (kernels/_build.py load):
// each function takes its arguments positionally as Python ints (pointers
// from tensor.data_ptr(), sizes, the device index, the raw handle of the
// current stream) or floats, converts them with the C API and calls the C
// entry of the same name. A METH_FASTCALL call costs about a tenth of a
// ctypes foreign call, which builds an argument object for every
// parameter; the small kernels' calls are mostly host time, so the
// difference shows in every launch. The argument formats here are the
// ones kernels/_build.py ENTRIES lists.

#include <Python.h>
#include <limits.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

extern "C" {
int vt_compress(const float* mean, const float* weight,
                const float* buf_value, const float* buf_weight,
                float* out_mean, float* out_weight, int K, int C, int B,
                double compression, int device, void* stream);
size_t vt_compress_smem_bytes(int C, int B);
int vt_compress_blocks_per_sm(int C, int B, int device);
int vt_hll_stats(const uint8_t* regs, float* ez, float* zsum, int K, int m,
                 int device, void* stream);
int vt_ull_insert(uint8_t* regs, const int32_t* slots, const int32_t* idx,
                  const uint8_t* vals, int n, int K, int m, int device,
                  void* stream);
int vt_probe(const float* x, float* out, int n, int device, void* stream);
}

namespace {

// one converted argument: 'p' a pointer, 'i' a C int, 'd' a double
union Arg {
  void* p;
  int i;
  double d;
};

// Converts the positional arguments by `fmt`; false, with a Python error
// set, on a wrong count or a value that does not convert.
bool parse(const char* name, const char* fmt, PyObject* const* args,
           Py_ssize_t n, Arg* out) {
  const Py_ssize_t want = (Py_ssize_t)strlen(fmt);
  if (n != want) {
    PyErr_Format(PyExc_TypeError, "%s takes %zd arguments (%zd given)", name,
                 want, n);
    return false;
  }
  for (Py_ssize_t k = 0; k < n; ++k) {
    if (fmt[k] == 'p') {
      out[k].p = PyLong_AsVoidPtr(args[k]);
    } else if (fmt[k] == 'i') {
      const long v = PyLong_AsLong(args[k]);
      if (v < INT_MIN || v > INT_MAX) {
        PyErr_Format(PyExc_OverflowError, "%s: argument %zd out of range",
                     name, k);
        return false;
      }
      out[k].i = (int)v;
    } else {
      out[k].d = PyFloat_AsDouble(args[k]);
    }
    if (PyErr_Occurred()) return false;
  }
  return true;
}

PyObject* py_compress(PyObject*, PyObject* const* args, Py_ssize_t n) {
  Arg a[12];
  if (!parse("vt_compress", "ppppppiiidip", args, n, a)) return NULL;
  return PyLong_FromLong(vt_compress(
      (const float*)a[0].p, (const float*)a[1].p, (const float*)a[2].p,
      (const float*)a[3].p, (float*)a[4].p, (float*)a[5].p, a[6].i, a[7].i,
      a[8].i, a[9].d, a[10].i, a[11].p));
}

PyObject* py_compress_smem_bytes(PyObject*, PyObject* const* args,
                                 Py_ssize_t n) {
  Arg a[2];
  if (!parse("vt_compress_smem_bytes", "ii", args, n, a)) return NULL;
  return PyLong_FromSize_t(vt_compress_smem_bytes(a[0].i, a[1].i));
}

PyObject* py_compress_blocks_per_sm(PyObject*, PyObject* const* args,
                                    Py_ssize_t n) {
  Arg a[3];
  if (!parse("vt_compress_blocks_per_sm", "iii", args, n, a)) return NULL;
  return PyLong_FromLong(vt_compress_blocks_per_sm(a[0].i, a[1].i, a[2].i));
}

PyObject* py_hll_stats(PyObject*, PyObject* const* args, Py_ssize_t n) {
  Arg a[7];
  if (!parse("vt_hll_stats", "pppiiip", args, n, a)) return NULL;
  return PyLong_FromLong(vt_hll_stats((const uint8_t*)a[0].p, (float*)a[1].p,
                                      (float*)a[2].p, a[3].i, a[4].i, a[5].i,
                                      a[6].p));
}

PyObject* py_ull_insert(PyObject*, PyObject* const* args, Py_ssize_t n) {
  Arg a[9];
  if (!parse("vt_ull_insert", "ppppiiiip", args, n, a)) return NULL;
  return PyLong_FromLong(vt_ull_insert(
      (uint8_t*)a[0].p, (const int32_t*)a[1].p, (const int32_t*)a[2].p,
      (const uint8_t*)a[3].p, a[4].i, a[5].i, a[6].i, a[7].i, a[8].p));
}

PyObject* py_probe(PyObject*, PyObject* const* args, Py_ssize_t n) {
  Arg a[5];
  if (!parse("vt_probe", "ppiip", args, n, a)) return NULL;
  return PyLong_FromLong(vt_probe((const float*)a[0].p, (float*)a[1].p,
                                  a[2].i, a[3].i, a[4].p));
}

#define FASTCALL(fn) (PyCFunction)(void (*)(void))(fn), METH_FASTCALL

PyMethodDef methods[] = {
    {"vt_compress", FASTCALL(py_compress), NULL},
    {"vt_compress_smem_bytes", FASTCALL(py_compress_smem_bytes), NULL},
    {"vt_compress_blocks_per_sm", FASTCALL(py_compress_blocks_per_sm), NULL},
    {"vt_hll_stats", FASTCALL(py_hll_stats), NULL},
    {"vt_ull_insert", FASTCALL(py_ull_insert), NULL},
    {"vt_probe", FASTCALL(py_probe), NULL},
    {NULL, NULL, 0, NULL},
};

PyModuleDef module = {PyModuleDef_HEAD_INIT, "_veneur_kernels", NULL, -1,
                      methods};

}  // namespace

PyMODINIT_FUNC PyInit__veneur_kernels(void) { return PyModule_Create(&module); }
