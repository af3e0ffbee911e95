// SGM path aggregation for NVIDIA Hopper, called from JAX through the XLA FFI.
//
// Design (Hernandez-Juarez et al., "Embedded real-time stereo estimation via
// Semi-Global Matching on the GPU", ICCS 2016; the libSGM layout):
//
// - One warp owns one path: a chain of pixels along one scan direction.
//   The host builds the table of chains (stereo/sgm_cuda.py:path_table), so
//   this file holds only the recurrence
//       L(p,d) = C(p,d) + min(L(p-r,d), L(p-r,d+-1) + P1, min_k L(p-r,k) + P2)
//                - min_k L(p-r,k)
//   and the traversal geometry stays testable on the CPU.
// - The D disparities lie across the warp's lanes, K = ceil(D/32) per lane,
//   contiguous (lane l holds d = l*K .. l*K+K-1). d-1 and d+1 of a lane's
//   edge elements and the min over D come from warp shuffles.
// - The cost volume is (H, W, D) with D contiguous, so each step's read of
//   one pixel's D costs is coalesced.
// - Chains of every direction run in one launch; each direction writes its
//   own plane of the (P, H, W, D) output, so no two warps write one address
//   and the result does not depend on scheduling. The planes are summed by
//   XLA in float32.
//
// Arithmetic is float32 whatever the storage type T (float or bfloat16).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr float kBig = 1e9f;  // the recurrence's out-of-range disparity
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 4;
constexpr int kPrefetch = 8;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = fminf(v, __shfl_xor_sync(kFull, v, off));
  }
  return v;
}

// paths[i] = (start pixel, pixel stride, length, output plane); pixel index
// is y * W + x.
template <typename T, int K>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
sgm_paths_kernel(const T* __restrict__ cost, const int4* __restrict__ paths,
                 int n_paths, int d, int64_t plane, T* __restrict__ out,
                 float p1, float p2) {
  const int warp = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (warp >= n_paths) return;  // uniform across the warp
  const int4 path = paths[warp];
  const int d0 = lane * K;
  const int64_t step = static_cast<int64_t>(path.y) * d;
  const T* c = cost + static_cast<int64_t>(path.x) * d + d0;
  T* o = out + path.w * plane + static_cast<int64_t>(path.x) * d + d0;

  bool live[K];
  float prev[K], next_cost[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    live[k] = d0 + k < d;
    // a zero carry is the fresh start: the first step yields L = C
    prev[k] = live[k] ? 0.0f : kBig;
    next_cost[k] = live[k] ? to_f32(c[k]) : 0.0f;
  }

  for (int s = 0; s < path.z; ++s) {
    float cur_cost[K];
#pragma unroll
    for (int k = 0; k < K; ++k) cur_cost[k] = next_cost[k];
    if (s + 1 < path.z) {  // prefetch the next pixel's costs
      c += step;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (live[k]) next_cost[k] = to_f32(c[k]);
      }
    }

    float local = prev[0];
#pragma unroll
    for (int k = 1; k < K; ++k) local = fminf(local, prev[k]);
    const float min_prev = warp_min(local);
    float left = __shfl_up_sync(kFull, prev[K - 1], 1);
    float right = __shfl_down_sync(kFull, prev[0], 1);
    if (lane == 0) left = kBig;
    if (lane == 31) right = kBig;

    float cur[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float dm = k == 0 ? left : prev[k - 1];
      const float dp = k == K - 1 ? right : prev[k + 1];
      const float best = fminf(fminf(prev[k], min_prev + p2),
                               fminf(dm + p1, dp + p1));
      cur[k] = live[k] ? cur_cost[k] + best - min_prev : kBig;
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      prev[k] = cur[k];
      if (live[k]) o[k] = from_f32<T>(cur[k]);
    }
    o += step;
  }
}

template <typename T, int K>
void launch(cudaStream_t stream, const void* cost, const int4* paths,
            int n_paths, int d, int64_t plane, void* out, float p1, float p2) {
  const int blocks = (n_paths + kWarpsPerBlock - 1) / kWarpsPerBlock;
  sgm_paths_kernel<T, K><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(cost), paths, n_paths, d, plane,
      static_cast<T*>(out), p1, p2);
}

template <typename T>
bool dispatch_k(cudaStream_t stream, const void* cost, const int4* paths,
                int n_paths, int d, int64_t plane, void* out, float p1,
                float p2) {
  if (d <= 32) {
    launch<T, 1>(stream, cost, paths, n_paths, d, plane, out, p1, p2);
  } else if (d <= 64) {
    launch<T, 2>(stream, cost, paths, n_paths, d, plane, out, p1, p2);
  } else if (d <= 128) {
    launch<T, 4>(stream, cost, paths, n_paths, d, plane, out, p1, p2);
  } else if (d <= 256) {
    launch<T, 8>(stream, cost, paths, n_paths, d, plane, out, p1, p2);
  } else {
    return false;
  }
  return true;
}

using PathTable = ffi::Buffer<ffi::S32, 2>;  // a macro argument takes no comma

ffi::Error SgmAggregateImpl(cudaStream_t stream, ffi::AnyBuffer cost,
                            PathTable paths,
                            ffi::Result<ffi::AnyBuffer> out, float p1,
                            float p2) {
  const auto cdims = cost.dimensions();
  const auto odims = out->dimensions();
  if (cdims.size() != 3 || odims.size() != 4 || paths.dimensions()[1] != 4) {
    return ffi::Error::InvalidArgument(
        "sgm_aggregate: want cost (H, W, D), paths (N, 4), out (P, H, W, D)");
  }
  if (cost.element_type() != out->element_type()) {
    return ffi::Error::InvalidArgument(
        "sgm_aggregate: cost and output dtypes differ");
  }
  const int d = static_cast<int>(cdims[2]);
  const int64_t plane = cdims[0] * cdims[1] * cdims[2];
  const int n_paths = static_cast<int>(paths.dimensions()[0]);
  const auto* table = reinterpret_cast<const int4*>(paths.typed_data());
  bool ok;
  switch (cost.element_type()) {
    case ffi::DataType::F32:
      ok = dispatch_k<float>(stream, cost.untyped_data(), table, n_paths, d,
                             plane, out->untyped_data(), p1, p2);
      break;
    case ffi::DataType::BF16:
      ok = dispatch_k<__nv_bfloat16>(stream, cost.untyped_data(), table,
                                     n_paths, d, plane, out->untyped_data(),
                                     p1, p2);
      break;
    default:
      return ffi::Error::InvalidArgument(
          "sgm_aggregate: storage dtype must be float32 or bfloat16");
  }
  if (!ok) {
    return ffi::Error::InvalidArgument("sgm_aggregate: D must be <= 256");
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return ffi::Error::Internal(cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(O3rSgmAggregate, SgmAggregateImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::AnyBuffer>()
                                  .Arg<PathTable>()
                                  .Ret<ffi::AnyBuffer>()
                                  .Attr<float>("p1")
                                  .Attr<float>("p2"));
