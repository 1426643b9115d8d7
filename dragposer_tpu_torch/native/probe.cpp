// A host like Unity's, for the tests and chip_smoke.py: it dlopens one of
// the port's libraries RTLD_LOCAL, as a P/Invoke host does (it does not link
// it), and runs the reference DLL's lifecycle (native/smoke_main.cpp) at the
// realtime defaults (max_iter 10, window 60) over N frames of tracker
// targets read from a file.
//
// Usage: probe <library.so> <model_dir> <skeleton.bvh> <targets.f32>
//              [--threads] [--report]
//
// targets.f32, little-endian float32: the mask (J), the weights (J x 2), the
// initial root position (3) and rotation (wxyz, 4), then for each frame the
// end effectors' positions (E x 3) and rotations (wxyz, E x 4); J is the
// skeleton's joint count and E the mask's end-effector count.
//
// Prints "setup <call> <ms>" for each set-up call, then for each frame
// "frame <f> <ms> <J x 4 parent-local wxyz> <root xyz>" (%.9g: float32 read
// back exactly; ms on the host clock around drag_pose).  --threads steps the
// first half of the frames on one new host thread and the rest on another,
// one after the other, on the same handle.  --report (the embedded library
// only) then runs a few lines of Python in the library's interpreter that
// print one "report <json>" line: the sessions' devices, the card, the
// kernels' launch counts and build seconds, the modules of the JAX package
// loaded (none expected).  Exits 3 when init_drag_poser returns null.

#include <dlfcn.h>

#include <chrono>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include "dragposer_abi.h"

namespace {

struct Api {
  DragPoser* (*init)();
  void (*set_reference_skeleton)(DragPoser*, char*);
  void (*load_models)(DragPoser*, char*);
  void (*set_mask_and_weights)(DragPoser*, float*, float2*);
  void (*init_drag_model)(DragPoser*, float3, quaternion);
  void (*set_optim_params)(DragPoser*, float, float, int, float);
  void (*set_lambdas)(DragPoser*, float, float, int);
  void (*set_global_pos)(DragPoser*, float3);
  void (*drag_pose)(DragPoser*, int, float3*, quaternion*, quaternion*,
                    float3*);
  void (*destroy)(DragPoser*);
  int (*num_joints)(DragPoser*);
  int (*num_end_effectors)(DragPoser*);
};

template <typename F>
bool bind(void* lib, const char* name, F* fn) {
  *fn = reinterpret_cast<F>(dlsym(lib, name));
  if (!*fn) std::fprintf(stderr, "probe: %s not exported\n", name);
  return *fn != nullptr;
}

double ms_since(std::chrono::steady_clock::time_point t0) {
  return std::chrono::duration<double, std::milli>(
             std::chrono::steady_clock::now() - t0)
      .count();
}

const char kReport[] =
    "import json, sys, torch\n"
    "from dragposer_tpu_torch import _build\n"
    "from dragposer_tpu_torch.runtime import capi\n"
    "print('report ' + json.dumps({\n"
    "    'devices': [str(s.device) for s in capi._sessions.values()],\n"
    "    'card': torch.cuda.get_device_name(0)\n"
    "            if torch.cuda.is_available() else None,\n"
    "    'kernels': _build.kernel_launches(),\n"
    "    'build_seconds': _build.BUILD_SECONDS,\n"
    "    'python': sys.executable, 'torch': torch.__file__,\n"
    "    'jax_package_modules': sorted(m for m in sys.modules\n"
    "        if m.split('.')[0] in ('jax', 'jaxlib', 'dragposer_tpu'))}),\n"
    "    flush=True)\n";

// The report runs through libpython's own entry points, found in the
// library's dependencies: the ABI has no export for it.
bool report(void* lib) {
  int (*ensure)() = nullptr;
  void (*release)(int) = nullptr;
  int (*run)(const char*) = nullptr;
  if (!bind(lib, "PyGILState_Ensure", &ensure) ||
      !bind(lib, "PyGILState_Release", &release) ||
      !bind(lib, "PyRun_SimpleString", &run)) {
    return false;
  }
  std::fflush(stdout);
  int gil = ensure();
  int rc = run(kReport);
  release(gil);
  return rc == 0;
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 5) {
    std::fprintf(stderr,
                 "usage: %s <library.so> <model_dir> <skeleton.bvh> "
                 "<targets.f32> [--threads] [--report]\n",
                 argv[0]);
    return 2;
  }
  bool threads = false, want_report = false;
  for (int i = 5; i < argc; ++i) {
    threads |= std::strcmp(argv[i], "--threads") == 0;
    want_report |= std::strcmp(argv[i], "--report") == 0;
  }
  void* lib = dlopen(argv[1], RTLD_NOW | RTLD_LOCAL);
  if (!lib) {
    std::fprintf(stderr, "probe: dlopen failed: %s\n", dlerror());
    return 2;
  }
  Api api;
  if (!bind(lib, "init_drag_poser", &api.init) ||
      !bind(lib, "set_reference_skeleton", &api.set_reference_skeleton) ||
      !bind(lib, "load_models", &api.load_models) ||
      !bind(lib, "set_mask_and_weights", &api.set_mask_and_weights) ||
      !bind(lib, "init_drag_model", &api.init_drag_model) ||
      !bind(lib, "set_optim_params", &api.set_optim_params) ||
      !bind(lib, "set_lambdas", &api.set_lambdas) ||
      !bind(lib, "set_global_pos", &api.set_global_pos) ||
      !bind(lib, "drag_pose", &api.drag_pose) ||
      !bind(lib, "destroy_drag_poser", &api.destroy) ||
      !bind(lib, "get_num_joints", &api.num_joints) ||
      !bind(lib, "get_num_end_effectors", &api.num_end_effectors)) {
    return 2;
  }
  std::vector<float> file;
  if (std::FILE* f = std::fopen(argv[4], "rb")) {
    float buf[1024];
    size_t n;
    while ((n = std::fread(buf, sizeof(float), 1024, f)) > 0) {
      file.insert(file.end(), buf, buf + n);
    }
    std::fclose(f);
  } else {
    std::fprintf(stderr, "probe: cannot read %s\n", argv[4]);
    return 2;
  }

  auto t0 = std::chrono::steady_clock::now();
  DragPoser* h = api.init();
  std::printf("setup init_drag_poser %.6f\n", ms_since(t0));
  if (!h) {
    std::fprintf(stderr, "probe: init_drag_poser returned null\n");
    return 3;
  }
  t0 = std::chrono::steady_clock::now();
  api.set_reference_skeleton(h, argv[3]);
  std::printf("setup set_reference_skeleton %.6f\n", ms_since(t0));
  const int j = api.num_joints(h);
  if (j <= 0 || file.size() < static_cast<size_t>(3 * j + 7)) {
    std::fprintf(stderr, "probe: %d joints; targets file too short\n", j);
    return 1;
  }
  t0 = std::chrono::steady_clock::now();
  api.load_models(h, argv[2]);
  std::printf("setup load_models %.6f\n", ms_since(t0));
  t0 = std::chrono::steady_clock::now();
  api.set_mask_and_weights(h, file.data(),
                           reinterpret_cast<float2*>(file.data() + j));
  std::printf("setup set_mask_and_weights %.6f\n", ms_since(t0));
  const int e = api.num_end_effectors(h);
  const float* init = file.data() + 3 * j;
  const float3 root = {init[0], init[1], init[2]};
  const quaternion rot = {init[3], init[4], init[5], init[6]};
  const float* targets = init + 7;
  const size_t per_frame = static_cast<size_t>(e) * 7;
  if (e <= 0 || (file.size() - (3 * j + 7)) % per_frame != 0) {
    std::fprintf(stderr, "probe: %d end effectors do not divide the file\n",
                 e);
    return 1;
  }
  const int frames = static_cast<int>((file.size() - (3 * j + 7)) / per_frame);
  t0 = std::chrono::steady_clock::now();
  api.init_drag_model(h, root, rot);
  std::printf("setup init_drag_model %.6f\n", ms_since(t0));
  t0 = std::chrono::steady_clock::now();
  api.set_optim_params(h, 1e-4f, 0.01f, /*maxIter=*/10, /*lr=*/0.01f);
  api.set_lambdas(h, 1.0f, 0.02f, /*temporalFutureWindow=*/60);
  api.set_global_pos(h, root);
  std::printf("setup set_optim_params+set_lambdas+set_global_pos %.6f\n",
              ms_since(t0));

  std::vector<float3> pos(e);
  std::vector<quaternion> q(e);
  std::vector<quaternion> pose(j);
  float3 global_pos;
  auto step = [&](int first, int last) {
    for (int f = first; f < last; ++f) {
      const float* t = targets + f * per_frame;
      for (int k = 0; k < e; ++k) {
        pos[k] = {t[3 * k], t[3 * k + 1], t[3 * k + 2]};
        const float* r = t + 3 * e + 4 * k;
        q[k] = {r[0], r[1], r[2], r[3]};
      }
      std::memset(pose.data(), 0, pose.size() * sizeof(quaternion));
      global_pos = {0, 0, 0};
      auto start = std::chrono::steady_clock::now();
      api.drag_pose(h, e, pos.data(), q.data(), pose.data(), &global_pos);
      const double ms = ms_since(start);
      std::printf("frame %d %.6f", f, ms);
      for (const quaternion& p : pose) {
        std::printf(" %.9g %.9g %.9g %.9g", p.w, p.x, p.y, p.z);
      }
      std::printf(" %.9g %.9g %.9g\n", global_pos.x, global_pos.y,
                  global_pos.z);
    }
  };
  if (threads) {
    std::thread first(step, 0, frames / 2);
    first.join();
    std::thread second(step, frames / 2, frames);
    second.join();
  } else {
    step(0, frames);
  }
  std::fflush(stdout);
  if (want_report && !report(lib)) {
    std::fprintf(stderr, "probe: the report failed\n");
    return 1;
  }
  api.destroy(h);
  std::printf("probe OK\n");
  return 0;
}
