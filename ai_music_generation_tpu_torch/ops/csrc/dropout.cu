// Counter-hash dropout of one training site in one pass: y[i] = x[i] / d
// where element i is kept, +0 where it is dropped, the keep bit made in
// registers from (key, layer, site, i) by hash32.cuh. The same pass over a
// gradient is the backward (kept: grad / d, dropped: +0), so the forward
// saves no mask and the backward recomputes it. The contract and the plain
// PyTorch twin live in ai_music_generation_tpu_torch/ops/dropout.py.
//
// Replaces no TPU kernel: the JAX package's dropout is flax's nn.Dropout,
// a jax.random Bernoulli mask that XLA fuses into its neighbours. The
// counter-hash mask is the port's own contract (ops/dropout.py), and this
// kernel is the port's counterpart of that fusion. Before it, the port
// built the mask with ~27 int64 torch passes a site (an arange, the three
// mul32s and the shifts of ops/dropout.py::dropout_keep), then a division
// and a where.
//
// Bit for bit what the twin computes:
// - the index is the row-major index in the site's full shape: i itself
//   for a whole site; for the block at `start` of a site that a mesh splits,
//   sum_d (start_d + i_d) * fullstride_d over up to 4 dims;
// - kept iff mix32(mul32(idx, GOLDEN) ^ k) >= threshold (hash32.cuh);
// - a kept value is __fdiv_rn(float(x), d) rounded to x's type to nearest:
//   one IEEE division, never a product with a reciprocal (torch's division
//   by a 0-dim tensor of x's type), with d the float value of 1 - p in x's
//   type.
//
// What bounds it: bytes. At the music model's attention probabilities
// ([64, 6, 256, 256] bf16, 25.2M elements) a pass reads and writes 2 bytes
// an element: 100.7 MB, 0.030 ms at 3.35 TB/s; on an H100 (700 W) a pass
// takes 0.040 ms, 0.75 of that bound. Each element also costs ~25 integer
// and float instructions (three 32-bit products, the shifts and xors, the
// compare, the division's fast path), ~0.6 G lane-instructions a pass,
// which the loads' latency hides. The design: 16 bytes a thread a load (8
// bf16 or 4 fp32), neighbouring threads on neighbouring addresses, a
// grid-stride loop over at most 8 blocks of 256 threads an SM, the ragged
// tail element by element; the mesh index (divisions) only in the mesh
// instantiation.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "hash32.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

// the block at `start` of a site of full shape, dims padded to 4 at the
// front (shape 1, start 0); every index fits 32 bits, since the full site
// holds fewer than 2^32 elements (the wrapper checks)
struct Mesh {
  uint32_t shape[4];   // the block's shape
  uint32_t start[4];   // its first element's coordinates in the site
  uint32_t stride[4];  // the full site's row-major strides
};

template <bool kMesh>
__device__ __forceinline__ uint32_t site_index(uint32_t i, const Mesh& m) {
  if (!kMesh) return i;
  uint32_t idx = 0;
#pragma unroll
  for (int d = 3; d >= 0; --d) {
    idx += (m.start[d] + i % m.shape[d]) * m.stride[d];
    i /= m.shape[d];
  }
  return idx;
}

template <typename T>
__device__ __forceinline__ T apply(T x, uint32_t idx, uint32_t k, uint64_t threshold, float d) {
  return dropout_kept(idx, k, threshold) ? from_float<T>(__fdiv_rn(to_float(x), d))
                                         : from_float<T>(0.0f);
}

template <typename T, bool kMesh>
__global__ void __launch_bounds__(kThreads)
    dropout_kernel(const T* __restrict__ x, T* __restrict__ y, uint64_t n, uint32_t k,
                   uint64_t threshold, float d, Mesh m) {
  constexpr int kVec = 16 / sizeof(T);
  const uint64_t n_vec = n / kVec;
  const uint64_t step = static_cast<uint64_t>(gridDim.x) * kThreads;
  const uint64_t first = static_cast<uint64_t>(blockIdx.x) * kThreads + threadIdx.x;
  for (uint64_t v = first; v < n_vec; v += step) {
    int4 w = reinterpret_cast<const int4*>(x)[v];
    T* e = reinterpret_cast<T*>(&w);
    const uint32_t i0 = static_cast<uint32_t>(v * kVec);
#pragma unroll
    for (int j = 0; j < kVec; ++j) e[j] = apply(e[j], site_index<kMesh>(i0 + j, m), k, threshold, d);
    reinterpret_cast<int4*>(y)[v] = w;
  }
  for (uint64_t i = n_vec * kVec + first; i < n; i += step)
    y[i] = apply(x[i], site_index<kMesh>(static_cast<uint32_t>(i), m), k, threshold, d);
}

int sm_count() {
  static int count[64];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && count[dev] == 0)
    cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev);
  return dev < 64 ? count[dev] : 132;
}

template <typename T>
cudaError_t launch(const void* x, void* y, uint64_t n, uint32_t k, uint64_t threshold, float d,
                   const long long* mesh, cudaStream_t stream) {
  constexpr uint64_t kVec = 16 / sizeof(T);
  const uint64_t work = n / kVec > 0 ? n / kVec : 1;
  const uint64_t cap = static_cast<uint64_t>(sm_count()) * kBlocksPerSm;
  const uint64_t want = (work + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < cap ? want : cap);
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  Mesh m{};
  if (mesh) {
    for (int a = 0; a < 4; ++a) {
      m.shape[a] = static_cast<uint32_t>(mesh[a]);
      m.start[a] = static_cast<uint32_t>(mesh[4 + a]);
      m.stride[a] = static_cast<uint32_t>(mesh[8 + a]);
    }
    dropout_kernel<T, true><<<blocks, kThreads, 0, stream>>>(xt, yt, n, k, threshold, d, m);
  } else {
    dropout_kernel<T, false><<<blocks, kThreads, 0, stream>>>(xt, yt, n, k, threshold, d, m);
  }
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). x and y are device pointers to
// n contiguous elements on 16-byte boundaries, fp32 when fp32 is set, else
// bf16; n > 0. k is the site's key, threshold round(p * 2^32), d the float
// value of 1 - p in x's type. mesh is null for a whole site, else 12 host
// values: the block's shape, its start and the full site's row-major
// strides, each padded to 4 dims at the front. Returns the cudaError_t of
// the launch (0 = launched).
extern "C" int dropout_apply_launch(const void* x, void* y, long long n, unsigned int k,
                                    unsigned long long threshold, float d, int fp32,
                                    const long long* mesh, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint64_t count = static_cast<uint64_t>(n);
  if (fp32) return static_cast<int>(launch<float>(x, y, count, k, threshold, d, mesh, st));
  return static_cast<int>(launch<__nv_bfloat16>(x, y, count, k, threshold, d, mesh, st));
}
