// CPU FFI handlers for the per-ray BVH walk (walk.h): a plain loop over the
// rays. Built with g++ -ffp-contract=off so its arithmetic rounds like the
// jnp reference's.
#include <cstdint>

#include "walk.h"
#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

const rf::Node* as_nodes(const ffi::Buffer<ffi::F32>& nodes) {
  return reinterpret_cast<const rf::Node*>(nodes.typed_data());
}

ffi::Error ClosestImpl(ffi::Buffer<ffi::F32> nodes, ffi::Buffer<ffi::F32> tris,
                       ffi::Buffer<ffi::F32> origin, ffi::Buffer<ffi::F32> direction,
                       ffi::Buffer<ffi::F32> t_max, ffi::ResultBuffer<ffi::F32> t_out,
                       ffi::ResultBuffer<ffi::S32> tri_out) {
  const int64_t n = static_cast<int64_t>(t_max.element_count());
  const float* o = origin.typed_data();
  const float* d = direction.typed_data();
  const float* tm = t_max.typed_data();
  float* t = t_out->typed_data();
  int32_t* tri = tri_out->typed_data();
  for (int64_t i = 0; i < n; ++i) {
    tri[i] = rf::walk(as_nodes(nodes), tris.typed_data(), o + 3 * i, d + 3 * i, tm[i],
                      /*any_hit=*/false, t + i);
  }
  return ffi::Error::Success();
}

ffi::Error AnyImpl(ffi::Buffer<ffi::F32> nodes, ffi::Buffer<ffi::F32> tris,
                   ffi::Buffer<ffi::F32> origin, ffi::Buffer<ffi::F32> direction,
                   ffi::Buffer<ffi::F32> t_max, ffi::ResultBuffer<ffi::S32> occluded) {
  const int64_t n = static_cast<int64_t>(t_max.element_count());
  const float* o = origin.typed_data();
  const float* d = direction.typed_data();
  const float* tm = t_max.typed_data();
  int32_t* occ = occluded->typed_data();
  for (int64_t i = 0; i < n; ++i) {
    float t;
    occ[i] = rf::walk(as_nodes(nodes), tris.typed_data(), o + 3 * i, d + 3 * i, tm[i],
                      /*any_hit=*/true, &t) >= 0;
  }
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(RfWalkClosestCpu, ClosestImpl,
                              ffi::Ffi::Bind()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Ret<ffi::Buffer<ffi::F32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>());

XLA_FFI_DEFINE_HANDLER_SYMBOL(RfWalkAnyCpu, AnyImpl,
                              ffi::Ffi::Bind()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>());
