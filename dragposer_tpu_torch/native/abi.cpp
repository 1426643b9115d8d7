// Embedded runtime of the PyTorch/CUDA port (the port of
// native/dragposer_abi.cpp): embeds CPython once per process and forwards
// the C ABI of dragposer_abi.h to dragposer_tpu_torch.runtime.capi.  Only
// scalars and bytes cross the boundary; a frame (drag_pose) is one Python
// call into the session, whose anchor runs on the card with its temporal
// rollout on kernel K2 (built by nvcc on first use, in the host process).
//
// Configuration (environment):
//   DRAGPOSER_PYROOT  - checkout holding the dragposer_tpu_torch package
//                       (compiled-in default: DRAGPOSER_DEFAULT_PYROOT)
//   DRAGPOSER_PYTHON  - the interpreter whose installation the embedded one
//                       takes: its prefix, virtual environment and
//                       site-packages, so the same torch (compiled-in
//                       default: DRAGPOSER_DEFAULT_PYTHON, the interpreter
//                       that built this library; the same Python version)
//   DRAGPOSER_DEVICE  - the sessions' torch device: cuda unless set ("cpu"
//                       runs the kernels' plain twins).  With no GPU and no
//                       "cpu", init_drag_poser logs the error and returns
//                       null: the library never runs on the CPU unasked.
//
// What a host relies on:
// * the GIL is released once the interpreter is up, so any host thread may
//   call any export (each takes the GIL for its call), and threads that
//   autograd runs the anchor's backward on are never starved;
// * libpython is made global before the interpreter starts: a P/Invoke
//   host dlopens this library RTLD_LOCAL, and extension modules that do not
//   link libpython (torch._C, numpy) must still find its symbols;
// * the interpreter is configured as DRAGPOSER_PYTHON (PyConfig's
//   program_name), so it needs no PYTHONHOME.

#include "dragposer_abi.h"

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <dlfcn.h>

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>

#ifndef DRAGPOSER_DEFAULT_PYTHON
#define DRAGPOSER_DEFAULT_PYTHON "python3"
#endif

namespace {

void log_line(const std::string& msg) {
  std::FILE* f = std::fopen("cpp_log.txt", "a");
  if (f) {
    std::fprintf(f, "%s\n", msg.c_str());
    std::fclose(f);
  }
}

// Log-and-clear for any Python exception raised behind an ABI call; the
// reference likewise logs rather than crashing the host (exportFunc.cpp:84-94).
bool check_py(const char* where) {
  if (!PyErr_Occurred()) return true;
  PyObject *type, *value, *trace;
  PyErr_Fetch(&type, &value, &trace);
  PyObject* repr = value ? PyObject_Str(value) : nullptr;
  const char* text = repr ? PyUnicode_AsUTF8(repr) : nullptr;
  std::string msg = std::string("python error in ") + where + ": " +
                    (text ? text : "<unknown>");
  log_line(msg);
  std::fprintf(stderr, "%s\n", msg.c_str());
  PyErr_Clear();  // PyUnicode_AsUTF8 may have raised
  Py_XDECREF(repr);
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(trace);
  return false;
}

const char* env_or(const char* name, const char* fallback) {
  const char* v = std::getenv(name);
  return v && *v ? v : fallback;
}

// Reopen the libpython this library was linked against with RTLD_GLOBAL:
// loaded as a dependency of an RTLD_LOCAL library, its symbols are hidden
// from the extension modules the interpreter loads later.
void promote_libpython() {
  Dl_info info;
  if (!dladdr(reinterpret_cast<void*>(&Py_InitializeFromConfig), &info) ||
      !info.dli_fname) {
    log_line("dladdr found no libpython");
    return;
  }
  if (!dlopen(info.dli_fname, RTLD_NOW | RTLD_GLOBAL | RTLD_NOLOAD)) {
    log_line(std::string("libpython not made global: ") + dlerror());
  }
}

bool start_interpreter() {
  promote_libpython();
  PyConfig config;
  PyConfig_InitPythonConfig(&config);
  config.install_signal_handlers = 0;  // the host owns its signals
  config.parse_argv = 0;
  PyStatus status = PyConfig_SetBytesString(
      &config, &config.program_name,
      env_or("DRAGPOSER_PYTHON", DRAGPOSER_DEFAULT_PYTHON));
  if (!PyStatus_Exception(status)) status = Py_InitializeFromConfig(&config);
  PyConfig_Clear(&config);
  if (PyStatus_Exception(status)) {
    std::string msg = std::string("python start failed: ") +
                      (status.err_msg ? status.err_msg : "<unknown>");
    log_line(msg);
    std::fprintf(stderr, "%s\n", msg.c_str());
    return false;
  }
  return true;
}

std::once_flag g_init_once;
PyObject* g_capi = nullptr;  // dragposer_tpu_torch.runtime.capi

void interpreter_init() {
  const bool ours = !Py_IsInitialized();
  if (ours && !start_interpreter()) return;
  PyGILState_STATE gil = PyGILState_Ensure();
  const char* pyroot = std::getenv("DRAGPOSER_PYROOT");
#ifdef DRAGPOSER_DEFAULT_PYROOT
  if (!pyroot) pyroot = DRAGPOSER_DEFAULT_PYROOT;
#endif
  if (pyroot) {
    PyObject* sys_path = PySys_GetObject("path");  // borrowed
    PyObject* p = PyUnicode_FromString(pyroot);
    PyList_Insert(sys_path, 0, p);
    Py_DECREF(p);
  }
  g_capi = PyImport_ImportModule("dragposer_tpu_torch.runtime.capi");
  check_py("import dragposer_tpu_torch.runtime.capi");
  PyGILState_Release(gil);
  // The thread that started the interpreter holds the GIL: release it, or
  // an export called from any other host thread waits forever.
  if (ours) PyEval_SaveThread();
}

// RAII GIL guard: every export may be called from any host thread.
struct Gil {
  PyGILState_STATE s;
  Gil() : s(PyGILState_Ensure()) {}
  ~Gil() { PyGILState_Release(s); }
};

}  // namespace

extern "C" {

struct DragPoser {
  long handle = 0;
  int num_joints = 0;
  int num_end_effectors = 0;
};

DRAGPOSER_EXPORT DragPoser* init_drag_poser() {
  std::call_once(g_init_once, interpreter_init);
  if (!g_capi) return nullptr;
  Gil gil;
  const char* device = std::getenv("DRAGPOSER_DEVICE");
  PyObject* res = device && *device
                      ? PyObject_CallMethod(g_capi, "init", "s", device)
                      : PyObject_CallMethod(g_capi, "init", nullptr);
  if (!check_py("init_drag_poser") || !res) {
    Py_XDECREF(res);
    return nullptr;
  }
  auto* h = new DragPoser();
  h->handle = PyLong_AsLong(res);
  Py_DECREF(res);
  log_line("init_drag_poser ok");
  return h;
}

DRAGPOSER_EXPORT void set_reference_skeleton(DragPoser* h, char* bvhPath) {
  if (!h) return;
  Gil gil;
  PyObject* res = PyObject_CallMethod(g_capi, "set_reference_skeleton", "ls",
                                      h->handle, bvhPath);
  if (check_py("set_reference_skeleton") && res) {
    h->num_joints = static_cast<int>(PyLong_AsLong(res));
  }
  Py_XDECREF(res);
}

DRAGPOSER_EXPORT void load_models(DragPoser* h, char* modelPath) {
  if (!h) return;
  Gil gil;
  PyObject* res =
      PyObject_CallMethod(g_capi, "load_models", "ls", h->handle, modelPath);
  check_py("load_models");
  Py_XDECREF(res);
}

DRAGPOSER_EXPORT void set_mask_and_weights(DragPoser* h, float* mask,
                                           float2* weights) {
  if (!h) return;
  Gil gil;
  const Py_ssize_t j = h->num_joints;
  PyObject* res = PyObject_CallMethod(
      g_capi, "set_mask_and_weights", "ly#y#", h->handle,
      reinterpret_cast<const char*>(mask), j * 4,
      reinterpret_cast<const char*>(weights), j * 8);
  if (check_py("set_mask_and_weights") && res) {
    h->num_end_effectors = static_cast<int>(PyLong_AsLong(res));
  }
  Py_XDECREF(res);
}

DRAGPOSER_EXPORT void init_drag_model(DragPoser* h, float3 p, quaternion q) {
  if (!h) return;
  Gil gil;
  PyObject* res = PyObject_CallMethod(
      g_capi, "init_drag_model", "lddddddd", h->handle, (double)p.x,
      (double)p.y, (double)p.z, (double)q.w, (double)q.x, (double)q.y,
      (double)q.z);
  check_py("init_drag_model");
  Py_XDECREF(res);
}

DRAGPOSER_EXPORT void set_optim_params(DragPoser* h, float stopEpsPos,
                                       float stopEpsRot, int maxIter,
                                       float lr) {
  if (!h) return;
  Gil gil;
  PyObject* res = PyObject_CallMethod(
      g_capi, "set_optim_params", "lddid", h->handle, (double)stopEpsPos,
      (double)stopEpsRot, maxIter, (double)lr);
  check_py("set_optim_params");
  Py_XDECREF(res);
}

DRAGPOSER_EXPORT void set_lambdas(DragPoser* h, float lambdaRot,
                                  float lambdaTemporal,
                                  int temporalFutureWindow) {
  if (!h) return;
  Gil gil;
  PyObject* res = PyObject_CallMethod(
      g_capi, "set_lambdas", "lddi", h->handle, (double)lambdaRot,
      (double)lambdaTemporal, temporalFutureWindow);
  check_py("set_lambdas");
  Py_XDECREF(res);
}

DRAGPOSER_EXPORT void set_global_pos(DragPoser* h, float3 p) {
  if (!h) return;
  Gil gil;
  PyObject* res = PyObject_CallMethod(g_capi, "set_global_pos", "lddd",
                                      h->handle, (double)p.x, (double)p.y,
                                      (double)p.z);
  check_py("set_global_pos");
  Py_XDECREF(res);
}

DRAGPOSER_EXPORT void drag_pose(DragPoser* h, int nEndEffectors,
                                float3* targetEEPos, quaternion* targetEERot,
                                quaternion* resultPose,
                                float3* resultGlobalPos) {
  if (!h) return;
  if (nEndEffectors != h->num_end_effectors) {
    log_line("drag_pose: nEndEffectors mismatch");
    return;
  }
  Gil gil;
  PyObject* res = PyObject_CallMethod(
      g_capi, "drag_pose", "ly#y#i", h->handle,
      reinterpret_cast<const char*>(targetEEPos),
      (Py_ssize_t)(nEndEffectors * 12),
      reinterpret_cast<const char*>(targetEERot),
      (Py_ssize_t)(nEndEffectors * 16), nEndEffectors);
  if (!check_py("drag_pose") || !res) return;
  char* buf = nullptr;
  Py_ssize_t len = 0;
  if (PyBytes_AsStringAndSize(res, &buf, &len) == 0) {
    const Py_ssize_t pose_bytes = (Py_ssize_t)h->num_joints * 16;
    if (len == pose_bytes + 12) {
      std::memcpy(resultPose, buf, pose_bytes);
      std::memcpy(resultGlobalPos, buf + pose_bytes, 12);
    } else {
      log_line("drag_pose: unexpected result size");
    }
  }
  check_py("drag_pose result");
  Py_DECREF(res);
}

DRAGPOSER_EXPORT void destroy_drag_poser(DragPoser* h) {
  if (!h) return;
  {
    Gil gil;
    PyObject* res = PyObject_CallMethod(g_capi, "destroy", "l", h->handle);
    check_py("destroy");
    Py_XDECREF(res);
  }
  delete h;
  log_line("destroy_drag_poser ok");
}

DRAGPOSER_EXPORT int get_num_joints(DragPoser* h) {
  return h ? h->num_joints : 0;
}
DRAGPOSER_EXPORT int get_num_end_effectors(DragPoser* h) {
  return h ? h->num_end_effectors : 0;
}

}  // extern "C"
