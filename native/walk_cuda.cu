// CUDA FFI handlers for the per-ray BVH walk (walk.h): one thread per ray,
// the stack in local memory. The handlers only enqueue on XLA's stream.
// Built with nvcc -fmad=false so the arithmetic rounds like the jnp
// reference's (no contraction to FMA).
#include <cstdint>

#include <cuda_runtime.h>

#include "walk.h"
#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kBlock = 128;

__global__ void __launch_bounds__(kBlock)
    closest_kernel(const rf::Node* __restrict__ nodes, const float* __restrict__ tris,
                   const float* __restrict__ o, const float* __restrict__ d,
                   const float* __restrict__ t_max, int64_t n, float* __restrict__ t,
                   int32_t* __restrict__ tri) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  if (i >= n) return;
  tri[i] = rf::walk(nodes, tris, o + 3 * i, d + 3 * i, t_max[i], /*any_hit=*/false, t + i);
}

__global__ void __launch_bounds__(kBlock)
    any_kernel(const rf::Node* __restrict__ nodes, const float* __restrict__ tris,
               const float* __restrict__ o, const float* __restrict__ d,
               const float* __restrict__ t_max, int64_t n, int32_t* __restrict__ occluded) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  if (i >= n) return;
  float t;
  occluded[i] = rf::walk(nodes, tris, o + 3 * i, d + 3 * i, t_max[i], /*any_hit=*/true, &t) >= 0;
}

const rf::Node* as_nodes(const ffi::Buffer<ffi::F32>& nodes) {
  return reinterpret_cast<const rf::Node*>(nodes.typed_data());
}

unsigned grid_for(int64_t n) { return static_cast<unsigned>((n + kBlock - 1) / kBlock); }

ffi::Error launch_status() {
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

ffi::Error ClosestImpl(cudaStream_t stream, ffi::Buffer<ffi::F32> nodes,
                       ffi::Buffer<ffi::F32> tris, ffi::Buffer<ffi::F32> origin,
                       ffi::Buffer<ffi::F32> direction, ffi::Buffer<ffi::F32> t_max,
                       ffi::ResultBuffer<ffi::F32> t_out, ffi::ResultBuffer<ffi::S32> tri_out) {
  const int64_t n = static_cast<int64_t>(t_max.element_count());
  if (n == 0) return ffi::Error::Success();
  closest_kernel<<<grid_for(n), kBlock, 0, stream>>>(
      as_nodes(nodes), tris.typed_data(), origin.typed_data(), direction.typed_data(),
      t_max.typed_data(), n, t_out->typed_data(), tri_out->typed_data());
  return launch_status();
}

ffi::Error AnyImpl(cudaStream_t stream, ffi::Buffer<ffi::F32> nodes, ffi::Buffer<ffi::F32> tris,
                   ffi::Buffer<ffi::F32> origin, ffi::Buffer<ffi::F32> direction,
                   ffi::Buffer<ffi::F32> t_max, ffi::ResultBuffer<ffi::S32> occluded) {
  const int64_t n = static_cast<int64_t>(t_max.element_count());
  if (n == 0) return ffi::Error::Success();
  any_kernel<<<grid_for(n), kBlock, 0, stream>>>(as_nodes(nodes), tris.typed_data(),
                                                 origin.typed_data(), direction.typed_data(),
                                                 t_max.typed_data(), n, occluded->typed_data());
  return launch_status();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(RfWalkClosestCuda, ClosestImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Ret<ffi::Buffer<ffi::F32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>());

XLA_FFI_DEFINE_HANDLER_SYMBOL(RfWalkAnyCuda, AnyImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>());
