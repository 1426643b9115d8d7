// Socket client of the PyTorch/CUDA port (the port of
// native/dragposer_client.cpp): the exports of dragposer_abi.h over the
// protocol of dragposer_tpu_torch/runtime/server.py on a Unix domain socket.
// Host processes start instantly, carry no interpreter or torch, and N of
// them share one daemon's warm engines and card.  When no daemon answers,
// the first call starts the port's daemon and waits for it.
//
// Configuration (environment; the same variables as native/'s client):
//   DRAGPOSER_SOCKET    - socket path (default /tmp/dragposer_tpu_torch.sock,
//                         the port daemon's DEFAULT_SOCKET)
//   DRAGPOSER_NO_SPAWN  - if set, never start a daemon
//   DRAGPOSER_PYTHON    - interpreter that runs a started daemon
//                         (compiled-in default: DRAGPOSER_DEFAULT_PYTHON, the
//                         interpreter that built this library)
//   DRAGPOSER_PYROOT    - checkout put first on a started daemon's PYTHONPATH
//                         (compiled-in default: DRAGPOSER_DEFAULT_PYROOT)
//   DRAGPOSER_DEVICE    - passed to a started daemon as --device (default:
//                         the daemon's, cuda)
//   DRAGPOSER_SPAWN_TIMEOUT - seconds to wait for the daemon (default 180)

#include "dragposer_abi.h"

#include <sys/socket.h>
#include <sys/un.h>
#include <sys/wait.h>
#include <unistd.h>

#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>
#include <vector>

#ifndef DRAGPOSER_DEFAULT_PYTHON
#define DRAGPOSER_DEFAULT_PYTHON "python3"
#endif

extern char** environ;

namespace {

// Opcode table: the contract with dragposer_tpu_torch/runtime/server.py.
enum Op : uint8_t {
  kPing = 0,
  kInit = 1,
  kDestroy = 2,
  kSetRefSkeleton = 3,
  kLoadModels = 4,
  kSetMaskWeights = 5,
  kInitDragModel = 6,
  kSetOptimParams = 7,
  kSetLambdas = 8,
  kSetGlobalPos = 9,
  kDragPose = 10,
};

void log_line(const std::string& msg) {
  std::FILE* f = std::fopen("cpp_log.txt", "a");
  if (f) {
    std::fprintf(f, "%s\n", msg.c_str());
    std::fclose(f);
  }
  std::fprintf(stderr, "%s\n", msg.c_str());
}

std::string socket_path() {
  const char* p = std::getenv("DRAGPOSER_SOCKET");
  return p ? p : "/tmp/dragposer_tpu_torch.sock";
}

int try_connect() {
  int fd = ::socket(AF_UNIX, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  sockaddr_un addr{};
  addr.sun_family = AF_UNIX;
  std::string path = socket_path();
  std::strncpy(addr.sun_path, path.c_str(), sizeof(addr.sun_path) - 1);
  if (::connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) == 0) {
    return fd;
  }
  ::close(fd);
  return -1;
}

// Start the port's daemon, detached (its own session: it outlives this
// client and serves other hosts until 300 s pass with no client).  Returns
// its pid, or -1.  The child runs only exec after fork (this host may have
// threads), so its arguments and environment are made before.
pid_t spawn_daemon() {
  const char* env_python = std::getenv("DRAGPOSER_PYTHON");
  const std::string python = env_python ? env_python : DRAGPOSER_DEFAULT_PYTHON;
  const char* pyroot = std::getenv("DRAGPOSER_PYROOT");
#ifdef DRAGPOSER_DEFAULT_PYROOT
  if (!pyroot) pyroot = DRAGPOSER_DEFAULT_PYROOT;
#endif
  std::vector<std::string> args = {python,      "-m",
                                   "dragposer_tpu_torch.runtime.server",
                                   "--socket",  socket_path(),
                                   "--idle-timeout", "300"};
  const char* device = std::getenv("DRAGPOSER_DEVICE");
  if (device && *device) {
    args.push_back("--device");
    args.push_back(device);
  }
  std::vector<std::string> env_strings;
  for (char** e = environ; *e; ++e) {
    if (!pyroot || std::strncmp(*e, "PYTHONPATH=", 11) != 0) {
      env_strings.push_back(*e);
    }
  }
  if (pyroot) {
    const char* old = std::getenv("PYTHONPATH");
    env_strings.push_back(std::string("PYTHONPATH=") + pyroot +
                          (old ? std::string(":") + old : std::string()));
  }
  std::vector<char*> argv, envp;
  for (auto& a : args) argv.push_back(&a[0]);
  argv.push_back(nullptr);
  for (auto& e : env_strings) envp.push_back(&e[0]);
  envp.push_back(nullptr);
  pid_t pid = ::fork();
  if (pid != 0) return pid;  // parent (or fork failure: -1)
  ::setsid();
  ::execvpe(argv[0], argv.data(), envp.data());
  std::_Exit(127);  // exec failed
}

// One connection per process, serialized: the daemon handles requests
// synchronously and the ABI itself is stateful per handle anyway.
std::mutex g_mutex;
int g_fd = -1;

bool send_all(int fd, const void* buf, size_t n) {
  const char* p = static_cast<const char*>(buf);
  while (n > 0) {
    ssize_t w = ::write(fd, p, n);
    if (w <= 0) {
      if (w < 0 && errno == EINTR) continue;
      return false;
    }
    p += w;
    n -= static_cast<size_t>(w);
  }
  return true;
}

bool recv_all(int fd, void* buf, size_t n) {
  char* p = static_cast<char*>(buf);
  while (n > 0) {
    ssize_t r = ::read(fd, p, n);
    if (r <= 0) {
      if (r < 0 && errno == EINTR) continue;
      return false;
    }
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

bool ensure_connected() {
  if (g_fd >= 0) return true;
  g_fd = try_connect();
  if (g_fd >= 0) return true;
  pid_t daemon = -1;
  if (!std::getenv("DRAGPOSER_NO_SPAWN")) {
    log_line("dragposer_client: no daemon, spawning one");
    daemon = spawn_daemon();
  }
  const char* t = std::getenv("DRAGPOSER_SPAWN_TIMEOUT");
  double timeout = t ? std::atof(t) : 180.0;
  for (double waited = 0.0; waited < timeout; waited += 0.2) {
    ::usleep(200000);
    g_fd = try_connect();
    if (g_fd >= 0) return true;
    if (daemon > 0 && ::waitpid(daemon, nullptr, WNOHANG) == daemon) {
      log_line("dragposer_client: the daemon exited before listening");
      break;
    }
  }
  log_line("dragposer_client: could not reach daemon at " + socket_path());
  return false;
}

// Send one request, receive the response payload.  Returns false (and logs)
// on transport or daemon-reported errors.
bool call(uint8_t op, const std::vector<char>& payload,
          std::vector<char>* out) {
  if (!ensure_connected()) return false;
  uint32_t len = static_cast<uint32_t>(payload.size()) + 1;
  std::vector<char> frame(4 + len);
  std::memcpy(frame.data(), &len, 4);
  frame[4] = static_cast<char>(op);
  std::memcpy(frame.data() + 5, payload.data(), payload.size());
  uint32_t rlen = 0;
  uint8_t status = 0;
  if (!send_all(g_fd, frame.data(), frame.size()) ||
      !recv_all(g_fd, &rlen, 4) || rlen < 1 ||
      !recv_all(g_fd, &status, 1)) {
    log_line("dragposer_client: transport error; dropping connection");
    ::close(g_fd);
    g_fd = -1;
    return false;
  }
  std::vector<char> body(rlen - 1);
  if (!body.empty() && !recv_all(g_fd, body.data(), body.size())) {
    ::close(g_fd);
    g_fd = -1;
    return false;
  }
  if (status != 0) {
    log_line("dragposer_client: daemon error: " +
             std::string(body.begin(), body.end()));
    return false;
  }
  if (out) *out = std::move(body);
  return true;
}

void put_i32(std::vector<char>* v, int32_t x) {
  v->insert(v->end(), reinterpret_cast<char*>(&x),
            reinterpret_cast<char*>(&x) + 4);
}
void put_i64(std::vector<char>* v, int64_t x) {
  v->insert(v->end(), reinterpret_cast<char*>(&x),
            reinterpret_cast<char*>(&x) + 8);
}
void put_f32(std::vector<char>* v, float x) {
  v->insert(v->end(), reinterpret_cast<char*>(&x),
            reinterpret_cast<char*>(&x) + 4);
}
void put_bytes(std::vector<char>* v, const void* p, size_t n) {
  const char* c = static_cast<const char*>(p);
  v->insert(v->end(), c, c + n);
}

}  // namespace

extern "C" {

struct DragPoser {
  int64_t handle = 0;
  int num_joints = 0;
  int num_end_effectors = 0;
};

DRAGPOSER_EXPORT DragPoser* init_drag_poser() {
  std::lock_guard<std::mutex> lock(g_mutex);
  std::vector<char> out;
  if (!call(kInit, {}, &out) || out.size() != 8) return nullptr;
  auto* h = new DragPoser();
  std::memcpy(&h->handle, out.data(), 8);
  log_line("init_drag_poser ok (daemon)");
  return h;
}

DRAGPOSER_EXPORT void set_reference_skeleton(DragPoser* h, char* bvhPath) {
  std::lock_guard<std::mutex> lock(g_mutex);
  std::vector<char> req, out;
  put_i64(&req, h->handle);
  put_bytes(&req, bvhPath, std::strlen(bvhPath));
  if (call(kSetRefSkeleton, req, &out) && out.size() == 4) {
    int32_t j;
    std::memcpy(&j, out.data(), 4);
    h->num_joints = j;
  }
}

DRAGPOSER_EXPORT void load_models(DragPoser* h, char* modelPath) {
  std::lock_guard<std::mutex> lock(g_mutex);
  std::vector<char> req;
  put_i64(&req, h->handle);
  put_bytes(&req, modelPath, std::strlen(modelPath));
  call(kLoadModels, req, nullptr);
}

DRAGPOSER_EXPORT void set_mask_and_weights(DragPoser* h, float* mask,
                                           float2* weights) {
  std::lock_guard<std::mutex> lock(g_mutex);
  std::vector<char> req, out;
  put_i64(&req, h->handle);
  put_i32(&req, h->num_joints);
  put_bytes(&req, mask, static_cast<size_t>(h->num_joints) * 4);
  put_bytes(&req, weights, static_cast<size_t>(h->num_joints) * 8);
  if (call(kSetMaskWeights, req, &out) && out.size() == 4) {
    int32_t e;
    std::memcpy(&e, out.data(), 4);
    h->num_end_effectors = e;
  }
}

DRAGPOSER_EXPORT void init_drag_model(DragPoser* h, float3 p, quaternion q) {
  std::lock_guard<std::mutex> lock(g_mutex);
  std::vector<char> req;
  put_i64(&req, h->handle);
  put_f32(&req, p.x);
  put_f32(&req, p.y);
  put_f32(&req, p.z);
  put_f32(&req, q.w);
  put_f32(&req, q.x);
  put_f32(&req, q.y);
  put_f32(&req, q.z);
  call(kInitDragModel, req, nullptr);
}

DRAGPOSER_EXPORT void set_optim_params(DragPoser* h, float stopEpsPos,
                                       float stopEpsRot, int maxIter,
                                       float lr) {
  std::lock_guard<std::mutex> lock(g_mutex);
  std::vector<char> req;
  put_i64(&req, h->handle);
  put_f32(&req, stopEpsPos);
  put_f32(&req, stopEpsRot);
  put_i32(&req, maxIter);
  put_f32(&req, lr);
  call(kSetOptimParams, req, nullptr);
}

DRAGPOSER_EXPORT void set_lambdas(DragPoser* h, float lambdaRot,
                                  float lambdaTemporal,
                                  int temporalFutureWindow) {
  std::lock_guard<std::mutex> lock(g_mutex);
  std::vector<char> req;
  put_i64(&req, h->handle);
  put_f32(&req, lambdaRot);
  put_f32(&req, lambdaTemporal);
  put_i32(&req, temporalFutureWindow);
  call(kSetLambdas, req, nullptr);
}

DRAGPOSER_EXPORT void set_global_pos(DragPoser* h, float3 p) {
  std::lock_guard<std::mutex> lock(g_mutex);
  std::vector<char> req;
  put_i64(&req, h->handle);
  put_f32(&req, p.x);
  put_f32(&req, p.y);
  put_f32(&req, p.z);
  call(kSetGlobalPos, req, nullptr);
}

DRAGPOSER_EXPORT void drag_pose(DragPoser* h, int nEndEffectors,
                                float3* targetEEPos, quaternion* targetEERot,
                                quaternion* resultPose,
                                float3* resultGlobalPos) {
  std::lock_guard<std::mutex> lock(g_mutex);
  if (nEndEffectors != h->num_end_effectors) {
    log_line("drag_pose: nEndEffectors mismatch");
    return;
  }
  std::vector<char> req, out;
  put_i64(&req, h->handle);
  put_i32(&req, nEndEffectors);
  put_bytes(&req, targetEEPos, static_cast<size_t>(nEndEffectors) * 12);
  put_bytes(&req, targetEERot, static_cast<size_t>(nEndEffectors) * 16);
  if (!call(kDragPose, req, &out)) return;
  const size_t pose_bytes = static_cast<size_t>(h->num_joints) * 16;
  if (out.size() == pose_bytes + 12) {
    std::memcpy(resultPose, out.data(), pose_bytes);
    std::memcpy(resultGlobalPos, out.data() + pose_bytes, 12);
  } else {
    log_line("drag_pose: unexpected result size");
  }
}

DRAGPOSER_EXPORT void destroy_drag_poser(DragPoser* h) {
  if (!h) return;
  {
    std::lock_guard<std::mutex> lock(g_mutex);
    std::vector<char> req;
    put_i64(&req, h->handle);
    call(kDestroy, req, nullptr);
  }
  delete h;
  log_line("destroy_drag_poser ok (daemon)");
}

DRAGPOSER_EXPORT int get_num_joints(DragPoser* h) { return h->num_joints; }
DRAGPOSER_EXPORT int get_num_end_effectors(DragPoser* h) {
  return h->num_end_effectors;
}

}  // extern "C"
