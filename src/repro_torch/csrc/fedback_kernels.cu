// Hand-written Hopper (sm_90a) kernels of the FedBack round's server passes.
//
// Built by repro_torch/kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes.
// Every entry point launches on the stream it is given, allocates
// nothing, and returns cudaGetLastError() so the Python wrapper can
// raise on a refused launch.  Tensors are fp32, row-major and
// contiguous; the wrappers check that before passing pointers.
//
// All three kernels move bytes and do almost no arithmetic, so on an
// H100 (3.35 TB/s HBM3, 67 TFLOP/s fp32) each is bound by memory
// traffic; the byte counts below are what one call must move.
//
// No kernel is compiled with fast math, and the elementwise ones
// contain no multiply, so nvcc has nothing to contract into an FMA:
// their outputs are bit-identical to the plain PyTorch versions.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// fused_gss: columns one block covers (4 per thread).
constexpr int kColsPerBlock = 4 * kThreads;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// ---------------------------------------------------------------------
// K1  trigger_sq_norms: r_i = sum_d (z_id - w_d)^2, fp32 accumulate.
//
// Replaces src/repro/kernels/trigger_norms.py::trigger_sq_norms (Pallas
// body `_kernel`, which carried the row sum in VMEM scratch across a
// sequential grid over D).  Bound: N*D*4 + D*4 bytes (63.6 MB at the
// paper-MNIST width N=100, D=159,010, about 19 us at 3.35 TB/s).
//
// Design: one block per client row.  Thread t sums the row-relative
// groups of 4 elements g = t, t + 256, ..., then the tail elements
// 4*floor(D/4) + t, so the order of the sum depends only on the row's
// values and never on where the row lies: identical rows give identical
// distances, as in the reference, and ties in the compact plan's
// priority are broken by client index on the card too.  A group is
// read with one 16-byte float4 load where the row start is 16-byte
// aligned, else with two 8-byte float2 loads (D = 159,010 is 2 mod 4,
// so odd rows start 8 bytes off), else with four scalar loads; the
// arithmetic is the same in all three.  w is shared by all rows and
// read through the read-only cache.  Each thread keeps one fp32
// partial; the block reduces them with warp shuffles and a
// shared-memory pass, in a fixed order, so the result is deterministic.
// The per-element square-and-add contracts into an FMA (one rounding),
// so the sum differs from the plain version only by summation order and
// that rounding.
//
// Known limit: one block per row gives only N blocks; at N=100 that is
// fewer than the 132 SMs, so the pass cannot reach the card's bandwidth.
// Splitting D across blocks with a second reduction pass is the fix.
template <int kVec>
__device__ __forceinline__ float4 load_group(const float* zr, int64_t g) {
  if (kVec == 4) return reinterpret_cast<const float4*>(zr)[g];
  if (kVec == 2) {
    const float2* p = reinterpret_cast<const float2*>(zr) + 2 * g;
    const float2 lo = p[0], hi = p[1];
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  }
  const float* p = zr + 4 * g;
  return make_float4(p[0], p[1], p[2], p[3]);
}

template <int kVec>
__device__ __forceinline__ float row_partial(const float* __restrict__ zr,
                                             const float* __restrict__ w,
                                             int64_t d) {
  const int64_t ngroups = d / 4;
  float acc = 0.f;
  for (int64_t g = threadIdx.x; g < ngroups; g += kThreads) {
    const float4 a = load_group<kVec>(zr, g);
    const float* wp = w + 4 * g;
    const float t0 = a.x - __ldg(wp);
    const float t1 = a.y - __ldg(wp + 1);
    const float t2 = a.z - __ldg(wp + 2);
    const float t3 = a.w - __ldg(wp + 3);
    acc += t0 * t0;
    acc += t1 * t1;
    acc += t2 * t2;
    acc += t3 * t3;
  }
  for (int64_t j = 4 * ngroups + threadIdx.x; j < d; j += kThreads) {
    const float t = zr[j] - __ldg(w + j);
    acc += t * t;
  }
  return acc;
}

__global__ void __launch_bounds__(kThreads)
trigger_sq_norms_kernel(const float* __restrict__ z,
                        const float* __restrict__ w,
                        float* __restrict__ out, int64_t d) {
  const float* zr = z + static_cast<int64_t>(blockIdx.x) * d;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(zr);
  float acc;
  if ((addr & 15u) == 0) {
    acc = row_partial<4>(zr, w, d);
  } else if ((addr & 7u) == 0) {
    acc = row_partial<2>(zr, w, d);
  } else {
    acc = row_partial<1>(zr, w, d);
  }

  __shared__ float partial[kWarps];
  acc = warp_sum(acc);
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x < 32) {
    float v = threadIdx.x < kWarps ? partial[threadIdx.x] : 0.f;
    v = warp_sum(v);
    if (threadIdx.x == 0) out[blockIdx.x] = v;
  }
}

// ---------------------------------------------------------------------
// K2  admm_update: lam+ = (lam + theta) - w ; z = theta + lam+ ;
//                  c = w - lam+           (elementwise over (N, D)).
//
// Replaces src/repro/kernels/admm_update.py::admm_update (Pallas bodies
// `_kernel3` / `_kernel2`).  Bound: (2 + outputs)*N*D*4 + D*4 bytes;
// the dense round's with_z=false form moves 4 streams, 254 MB at
// N=100, D=159,010 (about 76 us at 3.35 TB/s).
//
// Design: a grid-stride pass over the N*D elements with w at j % D, the
// z stream a template flag, and the reference's operation order.  The
// index type is 32-bit when N*D fits, which keeps the per-element
// modulo cheap.
template <bool kWithZ, typename Index>
__global__ void __launch_bounds__(kThreads)
admm_update_kernel(const float* __restrict__ th,
                   const float* __restrict__ la,
                   const float* __restrict__ w,
                   float* __restrict__ lam_out,
                   float* __restrict__ z_out,
                   float* __restrict__ c_out, Index total, Index d) {
  const Index stride = static_cast<Index>(gridDim.x) * kThreads;
  for (Index i = static_cast<Index>(blockIdx.x) * kThreads + threadIdx.x;
       i < total; i += stride) {
    const float t = th[i];
    const float wj = __ldg(w + i % d);
    const float lam_new = (la[i] + t) - wj;
    lam_out[i] = lam_new;
    if (kWithZ) z_out[i] = t + lam_new;
    c_out[i] = wj - lam_new;
  }
}

// ---------------------------------------------------------------------
// K3  fused_gss: for every capacity slot i with valid[i], at row
//     r = idx[i]:  lam+ = (lam[r] + theta[r]) - w ; theta[r] = solved[i] ;
//     lam[r] = lam+ ; z[r] = solved[i] + lam+          (in place).
//
// Replaces src/repro/kernels/fused_gss.py::fused_gss (Pallas bodies
// `_fused_gss3` / `_fused_gss2`, which gathered rows through
// scalar-prefetch BlockSpec index maps and wrote back through aliased
// outputs).  Bound: for V valid slots, reads theta/lam rows and the
// solved row, writes theta/lam (+z) rows: 6*V*D*4 bytes with z (5 without)
// plus w, 61 MB at V=16, D=159,010 (about 18 us at 3.35 TB/s).  Unlike
// the Pallas kernel, an invalid slot neither reads nor writes anything,
// so z_prev is never read.
//
// Design: grid (ceil(D / 1024), C); each block reads idx[i] and valid[i]
// itself, returns at once for an invalid slot (or an out-of-range row),
// and otherwise updates up to 1024 columns of the row, 4 per thread with
// neighbouring threads on neighbouring addresses.  Plan indices are
// distinct, so no two blocks write the same element.
template <bool kWithZ>
__global__ void __launch_bounds__(kThreads)
fused_gss_kernel(const int32_t* __restrict__ idx,
                 const bool* __restrict__ valid,
                 const float* __restrict__ solved,
                 const float* __restrict__ w, float* __restrict__ th,
                 float* __restrict__ la, float* __restrict__ z, int64_t n,
                 int64_t d) {
  const int64_t slot = blockIdx.y;
  if (!valid[slot]) return;
  const int64_t row = idx[slot];
  if (row < 0 || row >= n) return;
  float* thr = th + row * d;
  float* lar = la + row * d;
  const float* sr = solved + slot * d;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kColsPerBlock;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int64_t j = base + k * kThreads + threadIdx.x;
    if (j < d) {
      const float lam_new = (lar[j] + thr[j]) - __ldg(w + j);
      const float s = sr[j];
      thr[j] = s;
      lar[j] = lam_new;
      if (kWithZ) z[row * d + j] = s + lam_new;
    }
  }
}

int grid_for(int64_t total) {
  // Enough blocks to fill every SM several times over; the grid-stride
  // loop covers the rest.
  const int64_t want = (total + kThreads - 1) / kThreads;
  const int64_t cap = 132 * 16;
  return static_cast<int>(want < cap ? want : cap);
}

}  // namespace

extern "C" {

int fb_trigger_sq_norms(const float* z, const float* w, float* out,
                        int64_t n, int64_t d, void* stream) {
  trigger_sq_norms_kernel<<<static_cast<unsigned>(n), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(z, w, out, d);
  return static_cast<int>(cudaGetLastError());
}

int fb_admm_update(const float* th, const float* la, const float* w,
                   float* lam_out, float* z_out, float* c_out, int64_t n,
                   int64_t d, int with_z, void* stream) {
  const int64_t total = n * d;
  const int grid = grid_for(total);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (total < (int64_t{1} << 31)) {
    const uint32_t t32 = static_cast<uint32_t>(total);
    const uint32_t d32 = static_cast<uint32_t>(d);
    if (with_z) {
      admm_update_kernel<true, uint32_t><<<grid, kThreads, 0, s>>>(
          th, la, w, lam_out, z_out, c_out, t32, d32);
    } else {
      admm_update_kernel<false, uint32_t><<<grid, kThreads, 0, s>>>(
          th, la, w, lam_out, z_out, c_out, t32, d32);
    }
  } else if (with_z) {
    admm_update_kernel<true, int64_t><<<grid, kThreads, 0, s>>>(
        th, la, w, lam_out, z_out, c_out, total, d);
  } else {
    admm_update_kernel<false, int64_t><<<grid, kThreads, 0, s>>>(
        th, la, w, lam_out, z_out, c_out, total, d);
  }
  return static_cast<int>(cudaGetLastError());
}

int fb_fused_gss(const int32_t* idx, const bool* valid, const float* solved,
                 const float* w, float* th, float* la, float* z, int64_t c,
                 int64_t n, int64_t d, int with_z, void* stream) {
  const dim3 grid(static_cast<unsigned>((d + kColsPerBlock - 1) /
                                        kColsPerBlock),
                  static_cast<unsigned>(c));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (with_z) {
    fused_gss_kernel<true><<<grid, kThreads, 0, s>>>(idx, valid, solved, w,
                                                     th, la, z, n, d);
  } else {
    fused_gss_kernel<false><<<grid, kThreads, 0, s>>>(idx, valid, solved, w,
                                                      th, la, z, n, d);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
