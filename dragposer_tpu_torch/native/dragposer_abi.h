// C ABI of the PyTorch/CUDA port's native libraries.
//
// The reference DLL's export surface (DragPoserDLL/exportFunc.h:61-70): the
// same ten functions with the same POD argument layouts, plus the joint and
// end-effector counts, so a host built against the reference (e.g. the
// Unity C# P/Invoke wrapper) switches to the port by swapping the shared
// library.  Two libraries export it:
//
//   libdragposer_tpu_torch_native  (abi.cpp)    embeds CPython and forwards
//       each call to dragposer_tpu_torch.runtime.capi in the host process;
//       a session's frame runs on the card (the anchor, its rollout on K2);
//   libdragposer_tpu_torch_client  (client.cpp) speaks the protocol of
//       dragposer_tpu_torch.runtime.server over a Unix socket, starting the
//       daemon when none answers.
//
// Both are built by dragposer_tpu_torch._build.native_library.

#pragma once

#if defined(_WIN32)
#define DRAGPOSER_EXPORT __declspec(dllexport)
#else
#define DRAGPOSER_EXPORT __attribute__((visibility("default")))
#endif

extern "C" {

// POD layouts shared with the client (reference utils.h:13-41).
struct quaternion {
  float w, x, y, z;
};
struct float3 {
  float x, y, z;
};
struct float2 {
  float x, y;
};

struct DragPoser;  // opaque session handle

DRAGPOSER_EXPORT DragPoser* init_drag_poser();
DRAGPOSER_EXPORT void set_reference_skeleton(DragPoser* h, char* bvhPath);
DRAGPOSER_EXPORT void load_models(DragPoser* h, char* modelPath);
DRAGPOSER_EXPORT void set_mask_and_weights(DragPoser* h, float* mask,
                                           float2* weights);
DRAGPOSER_EXPORT void init_drag_model(DragPoser* h, float3 initialGlobalPos,
                                      quaternion initialGlobalRot);
DRAGPOSER_EXPORT void set_optim_params(DragPoser* h, float stopEpsPos,
                                       float stopEpsRot, int maxIter, float lr);
DRAGPOSER_EXPORT void set_lambdas(DragPoser* h, float lambdaRot,
                                  float lambdaTemporal,
                                  int temporalFutureWindow);
DRAGPOSER_EXPORT void set_global_pos(DragPoser* h, float3 globalPos);
DRAGPOSER_EXPORT void drag_pose(DragPoser* h, int nEndEffectors,
                                float3* targetEEPos, quaternion* targetEERot,
                                quaternion* resultPose,
                                float3* resultGlobalPos);
DRAGPOSER_EXPORT void destroy_drag_poser(DragPoser* h);

// Beyond the reference ABI: the loaded skeleton's joint count and the
// mask's end-effector count (reference clients hard-code 22 and 6).
DRAGPOSER_EXPORT int get_num_joints(DragPoser* h);
DRAGPOSER_EXPORT int get_num_end_effectors(DragPoser* h);

}  // extern "C"
