/*!
 * \file cxxnet_wrapper.cc
 * \brief The port's C ABI: embeds CPython and dispatches every call to
 *  cxxnet_tpu_torch.wrapper (DataIter / Net). See cxxnet_wrapper.h.
 *
 *  The counterpart of wrapper/cxxnet_wrapper.cc, whose library imports
 *  the JAX package; this one imports nothing of it. The library also
 *  works when loaded *into* a Python process (ctypes): it detects the
 *  live interpreter and only takes the GIL. cxxnet_tpu_torch.capi
 *  builds it with g++ at first use, against the building interpreter's
 *  headers and libpython; CXN_PYTHON_EXECUTABLE names that interpreter,
 *  so an interpreter this library starts finds the same installation
 *  (and virtual environment).
 */
#include "cxxnet_wrapper.h"

#include <Python.h>
#include <dlfcn.h>

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>
#include <vector>

namespace {

thread_local std::string g_last_error;
PyObject *g_module = nullptr;       // cxxnet_tpu_torch.wrapper
PyObject *g_numpy = nullptr;
std::once_flag g_init_flag;
bool g_ok = false;

void SetError(const char *where) {
  if (PyErr_Occurred()) {
    PyObject *type = nullptr, *val = nullptr, *tb = nullptr;
    PyErr_Fetch(&type, &val, &tb);
    PyErr_NormalizeException(&type, &val, &tb);
    PyObject *s = val ? PyObject_Str(val) : nullptr;
    const char *msg = s ? PyUnicode_AsUTF8(s) : "unknown python error";
    g_last_error = std::string(where) + ": " + (msg ? msg : "?");
    std::fprintf(stderr, "[cxxnet_wrapper] %s\n", g_last_error.c_str());
    Py_XDECREF(s);
    Py_XDECREF(type); Py_XDECREF(val); Py_XDECREF(tb);
  } else {
    g_last_error = std::string(where) + ": failed";
  }
}

/* repo root = three levels above this .so, which lives in
 * <root>/cxxnet_tpu_torch/_build */
std::string RepoRootFromSelf() {
  Dl_info info;
  if (dladdr(reinterpret_cast<void *>(&RepoRootFromSelf), &info) == 0 ||
      info.dli_fname == nullptr) {
    return "";
  }
  std::string p(info.dli_fname);
  for (int i = 0; i < 3; ++i) {
    size_t k = p.find_last_of('/');
    if (k == std::string::npos) return "";
    p.resize(k);
  }
  return p;
}

/* start an interpreter of our own (a C or Matlab host): no signal
 * handlers (the host owns them), the building interpreter's program
 * name so its prefix and site-packages are found */
bool StartInterpreter() {
  PyConfig config;
  PyConfig_InitPythonConfig(&config);
  config.install_signal_handlers = 0;
  config.parse_argv = 0;
  PyStatus st = PyStatus_Ok();
#ifdef CXN_PYTHON_EXECUTABLE
  st = PyConfig_SetBytesString(&config, &config.program_name,
                               CXN_PYTHON_EXECUTABLE);
#endif
  if (!PyStatus_Exception(st)) st = Py_InitializeFromConfig(&config);
  PyConfig_Clear(&config);
  if (PyStatus_Exception(st)) {
    g_last_error = std::string("python init: ") +
                   (st.err_msg != nullptr ? st.err_msg : "failed");
    std::fprintf(stderr, "[cxxnet_wrapper] %s\n", g_last_error.c_str());
    return false;
  }
  return true;
}

void InitRuntime() {
  bool we_own = false;
  if (!Py_IsInitialized()) {
    if (!StartInterpreter()) return;
    we_own = true;
  }
  PyGILState_STATE gil = PyGILState_Ensure();
  do {
    PyObject *sys_path = PySys_GetObject("path");   // borrowed
    if (sys_path != nullptr) {
      const char *env = std::getenv("CXXNET_TPU_PATH");
      std::string root = env != nullptr ? env : RepoRootFromSelf();
      if (!root.empty()) {
        PyObject *s = PyUnicode_FromString(root.c_str());
        PyList_Insert(sys_path, 0, s);
        Py_DECREF(s);
      }
    }
    g_numpy = PyImport_ImportModule("numpy");
    if (g_numpy == nullptr) { SetError("import numpy"); break; }
    g_module = PyImport_ImportModule("cxxnet_tpu_torch.wrapper");
    if (g_module == nullptr) {
      SetError("import cxxnet_tpu_torch.wrapper");
      break;
    }
    g_ok = true;
  } while (false);
  PyGILState_Release(gil);
  if (we_own) {
    // release the GIL held by the init thread so any thread can Ensure
    PyEval_SaveThread();
  }
}

bool EnsureRuntime() {
  std::call_once(g_init_flag, InitRuntime);
  return g_ok;
}

/* every handle owns its python object + a keepalive for the last
 * returned buffer (pointer stays valid until the next call) */
struct CXNObject {
  PyObject *obj;
  PyObject *keep;
};

class Gil {
 public:
  Gil() : state_(PyGILState_Ensure()) {}
  ~Gil() { PyGILState_Release(state_); }

 private:
  PyGILState_STATE state_;
};

/* np.frombuffer(bytearray, 'float32').reshape(shape): one copy of the
 * caller's data, which the array keeps alive; a bytearray (not bytes)
 * so the array is writable and torch.from_numpy takes it as it is */
PyObject *ArrayIn(const cxn_real_t *data, const cxn_uint *shape, int ndim) {
  size_t n = 1;
  for (int i = 0; i < ndim; ++i) n *= shape[i];
  PyObject *bytes = PyByteArray_FromStringAndSize(
      reinterpret_cast<const char *>(data),
      static_cast<Py_ssize_t>(n * sizeof(cxn_real_t)));
  if (bytes == nullptr) return nullptr;
  PyObject *flat = PyObject_CallMethod(g_numpy, "frombuffer", "(Os)",
                                       bytes, "float32");
  Py_DECREF(bytes);
  if (flat == nullptr) return nullptr;
  PyObject *shp = PyTuple_New(ndim);
  for (int i = 0; i < ndim; ++i) {
    PyTuple_SET_ITEM(shp, i, PyLong_FromUnsignedLong(shape[i]));
  }
  PyObject *arr = PyObject_CallMethod(flat, "reshape", "(O)", shp);
  Py_DECREF(flat);
  Py_DECREF(shp);
  return arr;
}

/* float32 C-contiguous view of a numpy result; stores the keepalive on
 * the handle and returns the raw data pointer + shape */
const cxn_real_t *ArrayOut(CXNObject *h, PyObject *arr,
                           cxn_uint *oshape, int max_dim,
                           cxn_uint *out_dim) {
  if (arr == nullptr) return nullptr;
  PyObject *conv = PyObject_CallMethod(
      g_numpy, "ascontiguousarray", "(Os)", arr, "float32");
  Py_DECREF(arr);
  if (conv == nullptr) { SetError("ascontiguousarray"); return nullptr; }
  PyObject *shape = PyObject_GetAttrString(conv, "shape");
  if (shape == nullptr) { Py_DECREF(conv); return nullptr; }
  int nd = static_cast<int>(PyTuple_Size(shape));
  if (nd > max_dim) {
    Py_DECREF(shape); Py_DECREF(conv);
    g_last_error = "result rank exceeds output shape buffer";
    return nullptr;
  }
  for (int i = 0; i < nd; ++i) {
    oshape[i] = static_cast<cxn_uint>(
        PyLong_AsUnsignedLong(PyTuple_GET_ITEM(shape, i)));
  }
  for (int i = nd; i < max_dim; ++i) oshape[i] = 1;
  if (out_dim != nullptr) *out_dim = static_cast<cxn_uint>(nd);
  Py_DECREF(shape);
  /* data pointer via arr.ctypes.data (no numpy C API dependency) */
  PyObject *ctypes_attr = PyObject_GetAttrString(conv, "ctypes");
  PyObject *dataptr = ctypes_attr != nullptr
      ? PyObject_GetAttrString(ctypes_attr, "data") : nullptr;
  Py_XDECREF(ctypes_attr);
  if (dataptr == nullptr) { Py_DECREF(conv); return nullptr; }
  void *p = PyLong_AsVoidPtr(dataptr);
  Py_DECREF(dataptr);
  Py_XDECREF(h->keep);
  h->keep = conv;                      // owns the buffer until next call
  return static_cast<const cxn_real_t *>(p);
}

PyObject *Call(PyObject *obj, const char *method, PyObject *args) {
  PyObject *fn = PyObject_GetAttrString(obj, method);
  if (fn == nullptr) { SetError(method); Py_XDECREF(args); return nullptr; }
  PyObject *r = PyObject_CallObject(fn, args);
  Py_DECREF(fn);
  Py_XDECREF(args);
  if (r == nullptr) SetError(method);
  return r;
}

CXNObject *AsObj(void *h) { return static_cast<CXNObject *>(h); }

}  // namespace

/* ------------------------------------------------------------ iterator */

void *CXNIOCreateFromConfig(const char *cfg) {
  if (!EnsureRuntime()) return nullptr;
  Gil gil;
  PyObject *cls = PyObject_GetAttrString(g_module, "DataIter");
  if (cls == nullptr) { SetError("DataIter"); return nullptr; }
  PyObject *it = PyObject_CallFunction(cls, "(s)", cfg);
  Py_DECREF(cls);
  if (it == nullptr) { SetError("DataIter()"); return nullptr; }
  return new CXNObject{it, nullptr};
}

int CXNIONext(void *handle) {
  Gil gil;
  PyObject *r = Call(AsObj(handle)->obj, "next", nullptr);
  if (r == nullptr) return 0;
  int ok = PyObject_IsTrue(r);
  Py_DECREF(r);
  return ok;
}

void CXNIOBeforeFirst(void *handle) {
  Gil gil;
  Py_XDECREF(Call(AsObj(handle)->obj, "before_first", nullptr));
}

const cxn_real_t *CXNIOGetData(void *handle, cxn_uint oshape[4],
                               cxn_uint *ostride) {
  Gil gil;
  CXNObject *h = AsObj(handle);
  PyObject *arr = Call(h->obj, "get_data", nullptr);
  const cxn_real_t *p = ArrayOut(h, arr, oshape, 4, nullptr);
  if (p != nullptr && ostride != nullptr) *ostride = oshape[3];
  return p;
}

const cxn_real_t *CXNIOGetLabel(void *handle, cxn_uint oshape[2],
                                cxn_uint *ostride) {
  Gil gil;
  CXNObject *h = AsObj(handle);
  PyObject *arr = Call(h->obj, "get_label", nullptr);
  const cxn_real_t *p = ArrayOut(h, arr, oshape, 2, nullptr);
  if (p != nullptr && ostride != nullptr) *ostride = oshape[1];
  return p;
}

void CXNIOFree(void *handle) {
  if (handle == nullptr) return;
  Gil gil;
  CXNObject *h = AsObj(handle);
  /* close() stops an iterator's threads and drains a net's monitor */
  if (PyObject_HasAttrString(h->obj, "close")) {
    Py_XDECREF(Call(h->obj, "close", nullptr));
  }
  Py_XDECREF(h->obj);
  Py_XDECREF(h->keep);
  delete h;
}

/* ----------------------------------------------------------------- net */

void *CXNNetCreate(const char *device, const char *cfg) {
  if (!EnsureRuntime()) return nullptr;
  Gil gil;
  PyObject *cls = PyObject_GetAttrString(g_module, "Net");
  if (cls == nullptr) { SetError("Net"); return nullptr; }
  PyObject *net = PyObject_CallFunction(cls, "(ss)", device, cfg);
  Py_DECREF(cls);
  if (net == nullptr) { SetError("Net()"); return nullptr; }
  return new CXNObject{net, nullptr};
}

void CXNNetFree(void *handle) { CXNIOFree(handle); }

void CXNNetSetParam(void *handle, const char *name, const char *val) {
  Gil gil;
  Py_XDECREF(Call(AsObj(handle)->obj, "set_param",
                  Py_BuildValue("(ss)", name, val)));
}

void CXNNetInitModel(void *handle) {
  Gil gil;
  Py_XDECREF(Call(AsObj(handle)->obj, "init_model", nullptr));
}

void CXNNetSaveModel(void *handle, const char *fname) {
  Gil gil;
  Py_XDECREF(Call(AsObj(handle)->obj, "save_model",
                  Py_BuildValue("(s)", fname)));
}

void CXNNetLoadModel(void *handle, const char *fname) {
  Gil gil;
  Py_XDECREF(Call(AsObj(handle)->obj, "load_model",
                  Py_BuildValue("(s)", fname)));
}

void CXNNetStartRound(void *handle, int round) {
  Gil gil;
  Py_XDECREF(Call(AsObj(handle)->obj, "start_round",
                  Py_BuildValue("(i)", round)));
}

void CXNNetSetWeight(void *handle, const cxn_real_t *p_weight,
                     cxn_uint size_weight, const char *layer_name,
                     const char *tag) {
  Gil gil;
  cxn_uint shape[1] = {size_weight};
  PyObject *arr = ArrayIn(p_weight, shape, 1);
  if (arr == nullptr) { SetError("set_weight"); return; }
  /* wrapper reshapes flat input against the stored weight shape */
  PyObject *obj = AsObj(handle)->obj;
  PyObject *r = PyObject_CallMethod(obj, "set_weight", "(Oss)",
                                    arr, layer_name, tag);
  Py_DECREF(arr);
  if (r == nullptr) SetError("set_weight"); else Py_DECREF(r);
}

const cxn_real_t *CXNNetGetWeight(void *handle, const char *layer_name,
                                  const char *tag, cxn_uint oshape[4],
                                  cxn_uint *out_dim) {
  Gil gil;
  CXNObject *h = AsObj(handle);
  PyObject *r = Call(h->obj, "get_weight",
                     Py_BuildValue("(ss)", layer_name, tag));
  if (r == nullptr || r == Py_None) {
    Py_XDECREF(r);
    if (out_dim != nullptr) *out_dim = 0;
    return nullptr;
  }
  return ArrayOut(h, r, oshape, 4, out_dim);
}

void CXNNetUpdateIter(void *handle, void *data_handle) {
  Gil gil;
  PyObject *r = PyObject_CallMethod(AsObj(handle)->obj, "update", "(O)",
                                    AsObj(data_handle)->obj);
  if (r == nullptr) SetError("update"); else Py_DECREF(r);
}

void CXNNetUpdateBatch(void *handle, const cxn_real_t *p_data,
                       const cxn_uint dshape[4],
                       const cxn_real_t *p_label,
                       const cxn_uint lshape[2]) {
  Gil gil;
  PyObject *data = ArrayIn(p_data, dshape, 4);
  PyObject *label = ArrayIn(p_label, lshape, 2);
  if (data == nullptr || label == nullptr) {
    Py_XDECREF(data); Py_XDECREF(label);
    SetError("update_batch");
    return;
  }
  PyObject *r = PyObject_CallMethod(AsObj(handle)->obj, "update", "(OO)",
                                    data, label);
  Py_DECREF(data); Py_DECREF(label);
  if (r == nullptr) SetError("update_batch"); else Py_DECREF(r);
}

const cxn_real_t *CXNNetPredictBatch(void *handle,
                                     const cxn_real_t *p_data,
                                     const cxn_uint dshape[4],
                                     cxn_uint *out_size) {
  Gil gil;
  CXNObject *h = AsObj(handle);
  PyObject *data = ArrayIn(p_data, dshape, 4);
  if (data == nullptr) { SetError("predict"); return nullptr; }
  PyObject *r = PyObject_CallMethod(h->obj, "predict", "(O)", data);
  Py_DECREF(data);
  if (r == nullptr) { SetError("predict"); return nullptr; }
  cxn_uint shape[4];
  const cxn_real_t *p = ArrayOut(h, r, shape, 4, nullptr);
  if (p != nullptr && out_size != nullptr) *out_size = shape[0];
  return p;
}

const cxn_real_t *CXNNetPredictIter(void *handle, void *data_handle,
                                    cxn_uint *out_size) {
  Gil gil;
  CXNObject *h = AsObj(handle);
  PyObject *r = PyObject_CallMethod(h->obj, "predict", "(O)",
                                    AsObj(data_handle)->obj);
  if (r == nullptr) { SetError("predict"); return nullptr; }
  cxn_uint shape[4];
  const cxn_real_t *p = ArrayOut(h, r, shape, 4, nullptr);
  if (p != nullptr && out_size != nullptr) *out_size = shape[0];
  return p;
}

const cxn_real_t *CXNNetExtractBatch(void *handle,
                                     const cxn_real_t *p_data,
                                     const cxn_uint dshape[4],
                                     const char *node_name,
                                     cxn_uint oshape[4]) {
  Gil gil;
  CXNObject *h = AsObj(handle);
  PyObject *data = ArrayIn(p_data, dshape, 4);
  if (data == nullptr) { SetError("extract"); return nullptr; }
  PyObject *r = PyObject_CallMethod(h->obj, "extract", "(Os)", data,
                                    node_name);
  Py_DECREF(data);
  if (r == nullptr) { SetError("extract"); return nullptr; }
  return ArrayOut(h, r, oshape, 4, nullptr);
}

const cxn_real_t *CXNNetExtractIter(void *handle, void *data_handle,
                                    const char *node_name,
                                    cxn_uint oshape[4]) {
  Gil gil;
  CXNObject *h = AsObj(handle);
  PyObject *r = PyObject_CallMethod(h->obj, "extract", "(Os)",
                                    AsObj(data_handle)->obj, node_name);
  if (r == nullptr) { SetError("extract"); return nullptr; }
  return ArrayOut(h, r, oshape, 4, nullptr);
}

const char *CXNNetEvaluate(void *handle, void *data_handle,
                           const char *name) {
  Gil gil;
  CXNObject *h = AsObj(handle);
  PyObject *r = PyObject_CallMethod(h->obj, "evaluate", "(Os)",
                                    AsObj(data_handle)->obj, name);
  if (r == nullptr) { SetError("evaluate"); return nullptr; }
  Py_XDECREF(h->keep);
  h->keep = r;                         // keep the str alive
  return PyUnicode_AsUTF8(r);
}

const char *CXNGetLastError(void) { return g_last_error.c_str(); }
