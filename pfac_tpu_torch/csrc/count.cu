// The sharded call's match count: the number of nonzero words of a result.
// Replaces the XLA count of pfac_tpu/dist/sharding.py::ShardedMatcher
// (count_fn, jnp.sum(matches > 0) over every shard's owned positions).
//
// Bound: device memory. The result is read once, 4 B a position (0.160 ms
// at 128 Mi positions and 3.35 TB/s); the output is one int64 word. Design:
// * one launch counts `nseg` segments of `len` words, `stride` words apart
//   (blockIdx.y a segment): the shards a device holds, laid out one after
//   another in one result buffer, in one node of the sharded program
//   (program.cu); a single tensor is one segment;
// * a thread reads 16-byte vectors, four in flight, in a grid-stride loop
//   over the segment's aligned body; the words before its first 16-byte
//   boundary and after its last go to the first threads one word each;
// * a warp reduction, then one over the CTA's warps, then one 64-bit
//   atomicAdd a CTA into the count (zeroed by the caller with
//   cudaMemsetAsync: the program before its launch, pfac_count before the
//   kernel). No flag tensor is written.
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

#include "launch.cuh"

namespace {

constexpr uint32_t kFull = 0xFFFFFFFFu;
constexpr int kThreads = 256;
constexpr int kUnroll = 4;                    // 16-byte loads in flight
constexpr int kCtasPerSm = 8;

__device__ __forceinline__ uint32_t nonzero(const int4 v) {
  return (v.x != 0) + (v.y != 0) + (v.z != 0) + (v.w != 0);
}

__global__ void __launch_bounds__(kThreads)
count_kernel(const int32_t* __restrict__ r, int64_t len, int64_t stride,
             unsigned long long* __restrict__ out) {
  __shared__ uint32_t warp_sum[kThreads / 32];
  const int32_t* s = r + static_cast<int64_t>(blockIdx.y) * stride;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t nth = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t lead = (16 - reinterpret_cast<uintptr_t>(s) % 16) % 16 / 4;
  const int64_t head = lead < len ? lead : len;
  const int64_t nvec = (len - head) / 4;
  const int64_t tail = head + 4 * nvec;
  const int4* v = reinterpret_cast<const int4*>(s + head);
  uint32_t c = 0;
  if (tid < head) c += s[tid] != 0;
  if (tid < len - tail) c += s[tail + tid] != 0;
  int64_t i = tid;
  for (; i + (kUnroll - 1) * nth < nvec; i += kUnroll * nth) {
    int4 w[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) w[k] = __ldg(v + i + k * nth);
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) c += nonzero(w[k]);
  }
  for (; i < nvec; i += nth) c += nonzero(__ldg(v + i));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  c = __reduce_add_sync(kFull, c);
  if (lane == 0) warp_sum[warp] = c;
  __syncthreads();
  if (warp == 0) {
    uint32_t x = lane < kThreads / 32 ? warp_sum[lane] : 0u;
    x = __reduce_add_sync(kFull, x);
    if (lane == 0 && x != 0) atomicAdd(out, static_cast<unsigned long long>(x));
  }
}

int sm_count(int device) {
  constexpr int kDevices = 64;
  static int sms[kDevices];
  static std::mutex mu;
  if (device < 0 || device >= kDevices) return 0;
  std::lock_guard<std::mutex> lock(mu);
  if (sms[device] == 0 &&
      cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount,
                             device) != cudaSuccess)
    return 0;
  return sms[device];
}

}  // namespace

// r: int32, 4-byte aligned, segments [k * stride, k * stride + len) for k <
// nseg, 0 <= len <= stride < 2^31, nseg >= 1; out: int64, the count added
// into it. The grid follows `stride`: a program keeps it across calls
// whatever `len`. Else cudaErrorInvalidValue.
cudaError_t pfac::count_launch(int device, const void* r, int64_t len,
                               int64_t stride, int32_t nseg, void* out,
                               Launch* l) {
  *l = Launch{};
  if (len < 0 || stride < len || stride < 1 || stride >= (1LL << 31) ||
      nseg < 1 || reinterpret_cast<uintptr_t>(r) % 4 != 0)
    return cudaErrorInvalidValue;
  const int sms = sm_count(device);
  if (sms == 0) return cudaErrorInvalidDevice;
  const int64_t want = (stride + 4LL * kUnroll * kThreads - 1) /
                       (4LL * kUnroll * kThreads);
  const int64_t room = (static_cast<int64_t>(kCtasPerSm) * sms + nseg - 1) / nseg;
  const int64_t per = want < room ? want : room;
  l->set(count_kernel, static_cast<unsigned>(per), kThreads, 0,
         static_cast<const int32_t*>(r), len, stride,
         static_cast<unsigned long long*>(out));
  l->grid.y = static_cast<unsigned>(nseg);
  return cudaSuccess;
}

// As count_launch, with *out zeroed first on `stream`; returns the first
// cudaError_t.
extern "C" int pfac_count(int device, const void* r, int64_t len,
                          int64_t stride, int32_t nseg, void* out,
                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  pfac::Launch l;
  err = pfac::count_launch(device, r, len, stride, nseg, out, &l);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(out, 0, sizeof(int64_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(l.launch(s));
}
