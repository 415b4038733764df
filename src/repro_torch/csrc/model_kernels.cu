// Hand-written Hopper (sm_90a) kernels of the model zoo's prefill:
// K4 flash_attention and K5 ssd_scan.
//
// Built by repro_torch/kernels/_build.py beside fedback_kernels.cu (one
// nvcc -c per source, started together, then linked into one shared
// library with a plain C interface, loaded with ctypes).  Every entry
// point launches on the stream it is given, allocates nothing, and
// returns the CUDA error of the launch so the Python wrapper can raise
// on a refused launch.  The wrappers check dtypes, shapes and strides
// before passing pointers.  No kernel is compiled with fast math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);  // round to nearest even, as torch casts
}

// ---------------------------------------------------------------------
// K4  flash_attention: out = softmax(mask(q k^T * hd^-1/2)) v per head,
//     GQA head h reading kv head h / (H / KvH); m, l, acc in fp32.
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention (Pallas
// body `_kernel`, grid (B*H, q-blocks, kv-blocks) with the kv axis
// sequential and m/l/acc in VMEM scratch).  Bound at the zamba2-2.7b
// prefill, q (4, 32, 2048, 80) bf16, causal: 4*B*H*hd * (allowed pairs)
// = 8.6e10 operations, 0.087 ms at 989 TFLOP/s bf16 on the tensor
// cores, against 84 MB of q/k/v/out, 0.025 ms at 3.35 TB/s: bound by
// operations.
//
// Design (a simple kernel that is right; tensor cores come later): one
// block of 256 threads per (64-row query tile, batch*head), heaviest
// causal tiles first.  The block walks the 64-key tiles that the mask
// can reach — none right of the diagonal, none left of the window, as
// the Pallas grid's pl.when(reachable) — staging K and V in shared
// memory as fp32.  Each thread computes a 4x4 patch of the 64x64 score
// tile with fp32 FMAs on float4 reads (rows ty*4+i, keys tx+16j, rows
// padded by 4 floats so the 16 key rows of a half-warp fall on distinct
// banks), masks it (ragged S, causal, window) with -inf, and four
// threads per row carry the online softmax's m and l; each thread then
// accumulates its 4 rows x hd/16 columns of P v in registers.  Inputs
// may be any strides with a contiguous head dim, so the model's
// (B, S, H, hd) layout needs no transpose.  The probabilities stay fp32
// (the Pallas kernel's numerics); rows never fully masked by causal
// masks, and a row masked so far contributes nothing (p = 0, corr = 1).
constexpr int kBq = 64;
constexpr int kBk = 64;
constexpr int kAttnThreads = 256;
constexpr int kPtLd = kBq + 4;  // row stride of the transposed P tile

struct Strides {
  int64_t b, h, s;  // in elements; the head dim is contiguous
};

template <int kNc>
__host__ __device__ constexpr int row_ld() {
  return kNc * 16 + 4;  // hd + 4: distinct banks for keys tx + 16j
}

template <int kNc>
__host__ __device__ constexpr size_t attn_smem_bytes() {
  return sizeof(float) *
         (3 * kBq * row_ld<kNc>() + kBk * kPtLd + 3 * kBq);
}

template <typename T, int kNc>
__global__ void __launch_bounds__(kAttnThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       Strides sq, Strides sk, Strides sv, Strides so,
                       int h, int group, int s, int causal, int window,
                       float scale) {
  constexpr int kHd = kNc * 16;
  constexpr int kLd = row_ld<kNc>();
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kBq][kLd], scaled q
  float* ks = qs + kBq * kLd;                     // [kBk][kLd]
  float* vs = ks + kBk * kLd;                     // [kBk][kLd]
  float* pt = vs + kBk * kLd;                     // [kBk][kPtLd], P^T
  float* m_s = pt + kBk * kPtLd;                  // [kBq] running max
  float* l_s = m_s + kBq;                         // [kBq] running sum
  float* corr_s = l_s + kBq;                      // [kBq] this tile's rescale

  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // rows ty*4 .. ty*4+3
  const int tx = tid & 15;  // keys tx + 16j; output columns tx + 16c
  const int n_qt = (s + kBq - 1) / kBq;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * kBq;
  const int bh = blockIdx.y;
  const int b = bh / h;
  const int head = bh % h;
  const int kv_head = head / group;

  const T* qb = q + b * sq.b + head * sq.h;
  const T* kb = k + b * sk.b + kv_head * sk.h;
  const T* vb = v + b * sv.b + kv_head * sv.h;
  T* ob = o + b * so.b + head * so.h;

  for (int i = tid; i < kBq * kHd; i += kAttnThreads) {
    const int r = i / kHd, d = i % kHd;
    const int qi = q0 + r;
    qs[r * kLd + d] =
        qi < s ? to_f32(qb[static_cast<int64_t>(qi) * sq.s + d]) * scale
               : 0.f;
  }
  if (tid < kBq) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  // The key tiles the mask can reach from rows q0 .. q_last.
  const int q_last = min(q0 + kBq, s) - 1;
  int t_lo = 0;
  int t_hi = (s + kBk - 1) / kBk;
  if (causal) t_hi = min(t_hi, q_last / kBk + 1);
  if (window > 0 && q0 - window + 1 > 0) t_lo = (q0 - window + 1) / kBk;

  float acc[4][kNc];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < kNc; ++c) acc[i][c] = 0.f;
  }

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * kBk;
    __syncthreads();  // the previous tile's P v is done with ks/vs/pt
    for (int i = tid; i < kBk * kHd; i += kAttnThreads) {
      const int r = i / kHd, d = i % kHd;
      const int ki = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (ki < s) {
        kv = to_f32(kb[static_cast<int64_t>(ki) * sk.s + d]);
        vv = to_f32(vb[static_cast<int64_t>(ki) * sv.s + d]);
      }
      ks[r * kLd + d] = kv;
      vs[r * kLd + d] = vv;
    }
    __syncthreads();

    // S = (q * scale) k^T for rows ty*4+i, keys tx+16j.
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    }
#pragma unroll 4
    for (int d = 0; d < kHd; d += 4) {
      float4 qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qa[i] = *reinterpret_cast<const float4*>(qs + (ty * 4 + i) * kLd + d);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ka[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * kLd + d);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = sc[i][j];
          a = fmaf(qa[i].x, ka[j].x, a);
          a = fmaf(qa[i].y, ka[j].y, a);
          a = fmaf(qa[i].z, ka[j].z, a);
          a = fmaf(qa[i].w, ka[j].w, a);
          sc[i][j] = a;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = tx + 16 * j;
      const int key = k0 + col;
      float vals[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qi = q0 + ty * 4 + i;
        bool ok = key < s;
        if (causal) ok = ok && key <= qi;
        if (window > 0) ok = ok && key > qi - window;
        vals[i] = ok ? sc[i][j] : -INFINITY;
      }
      *reinterpret_cast<float4*>(pt + col * kPtLd + ty * 4) =
          make_float4(vals[0], vals[1], vals[2], vals[3]);
    }
    __syncthreads();

    // Online softmax: four neighbouring lanes per row.
    {
      const int r = tid >> 2;
      const int part = tid & 3;
      float mx = -INFINITY;
      for (int c = part; c < kBk; c += 4) mx = fmaxf(mx, pt[c * kPtLd + r]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      const bool empty = m_new == -INFINITY;  // every key so far masked
      float sum = 0.f;
      for (int c = part; c < kBk; c += 4) {
        const float p = empty ? 0.f : expf(pt[c * kPtLd + r] - m_new);
        pt[c * kPtLd + r] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float corr = empty ? 1.f : expf(m_old - m_new);
        corr_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + P v for rows ty*4+i, columns tx + 16c.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = corr_s[ty * 4 + i];
#pragma unroll
      for (int c = 0; c < kNc; ++c) acc[i][c] *= corr;
    }
#pragma unroll 4
    for (int j = 0; j < kBk; ++j) {
      const float4 p4 =
          *reinterpret_cast<const float4*>(pt + j * kPtLd + ty * 4);
#pragma unroll
      for (int c = 0; c < kNc; ++c) {
        const float vv = vs[j * kLd + tx + 16 * c];
        acc[0][c] = fmaf(p4.x, vv, acc[0][c]);
        acc[1][c] = fmaf(p4.y, vv, acc[1][c]);
        acc[2][c] = fmaf(p4.z, vv, acc[2][c]);
        acc[3][c] = fmaf(p4.w, vv, acc[3][c]);
      }
    }
  }
  __syncthreads();  // l_s is final

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const int qi = q0 + r;
    if (qi >= s) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
    T* orow = ob + static_cast<int64_t>(qi) * so.s;
#pragma unroll
    for (int c = 0; c < kNc; ++c) {
      orow[tx + 16 * c] = from_f32<T>(acc[i][c] / l);
    }
  }
}

template <typename T, int kNc>
int launch_flash_attention(const void* q, const void* k, const void* v,
                           void* o, Strides sq, Strides sk, Strides sv,
                           Strides so, int b, int h, int group, int s,
                           int causal, int window, float scale,
                           cudaStream_t stream) {
  constexpr size_t smem = attn_smem_bytes<kNc>();
  auto kernel = flash_attention_kernel<T, kNc>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s + kBq - 1) / kBq, b * h);
  kernel<<<grid, kAttnThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, sv, so, h, group,
      s, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_flash_attention(int nc, const void* q, const void* k,
                             const void* v, void* o, Strides sq, Strides sk,
                             Strides sv, Strides so, int b, int h, int group,
                             int s, int causal, int window, float scale,
                             cudaStream_t stream) {
#define FA_CASE(N)                                                          \
  case N:                                                                   \
    return launch_flash_attention<T, N>(q, k, v, o, sq, sk, sv, so, b, h,  \
                                        group, s, causal, window, scale,   \
                                        stream);
  switch (nc) {
    FA_CASE(1)
    FA_CASE(2)
    FA_CASE(3)
    FA_CASE(4)
    FA_CASE(5)
    FA_CASE(6)
    FA_CASE(7)
    FA_CASE(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FA_CASE
}

// ---------------------------------------------------------------------
// K5  ssd_scan: h_prev[c] = H_c,  H_0 = 0,  H_{c+1} = H_c * a_c + S_c,
//     with an fp32 carry; h_last = H_C in fp32.
//
// Replaces src/repro/kernels/ssd_scan.py::ssd_scan (Pallas body
// `_kernel`, grid (B*H, C) with the chunk axis sequential and the (P, N)
// carry in VMEM).  Bound at the zamba2-2.7b prefill, states
// (4, 32, 80, 64, 64) bf16: 2*B*C*H*P*N*2 bytes of states in and h_prev
// out, plus 4*B*H*P*N bytes of h_last and the decays, 173 MB, about
// 0.052 ms at 3.35 TB/s: bound by bytes (one multiply and one add per
// element).
//
// Design: grid (B*H, ceil(P*N / 256)); each thread owns one element of
// one (batch, head)'s P x N plane, keeps its carry in a register and
// walks the chunks in order, reading the states where they lie in the
// (B, C, H, P, N) layout (neighbouring threads on neighbouring
// elements, a stride of H*P*N between chunks), so no transposed copy
// is made.  carry * a and + s are rounded one at a time (__fmul_rn,
// __fadd_rn): bit-equal to the plain version, which rounds the product
// first.
constexpr int kScanThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kScanThreads)
ssd_scan_kernel(const T* __restrict__ states,
                const float* __restrict__ decays, T* __restrict__ h_prev,
                float* __restrict__ h_last, int c, int h, int64_t pn) {
  const int64_t bh = blockIdx.x;
  const int64_t e =
      static_cast<int64_t>(blockIdx.y) * kScanThreads + threadIdx.x;
  if (e >= pn) return;
  const int64_t b = bh / h, head = bh % h;
  const int64_t step = static_cast<int64_t>(h) * pn;  // one chunk
  int64_t off = (b * c * h + head) * pn + e;
  const float* dec = decays + b * c * h + head;
  float carry = 0.f;
#pragma unroll 4
  for (int j = 0; j < c; ++j) {
    const float sj = to_f32(states[off]);
    const float a = __ldg(dec + static_cast<int64_t>(j) * h);
    h_prev[off] = from_f32<T>(carry);
    carry = __fadd_rn(__fmul_rn(carry, a), sj);
    off += step;
  }
  h_last[bh * pn + e] = carry;
}

}  // namespace

extern "C" {

int mk_flash_attention(const void* q, const void* k, const void* v, void* o,
                       int64_t sqb, int64_t sqh, int64_t sqs, int64_t skb,
                       int64_t skh, int64_t sks, int64_t svb, int64_t svh,
                       int64_t svs, int64_t sob, int64_t soh, int64_t sos,
                       int64_t b, int64_t h, int64_t kvh, int64_t s,
                       int64_t hd, int causal, int window, int bf16,
                       float scale, void* stream) {
  if (hd % 16 != 0 || hd < 16 || hd > 128 || kvh <= 0 || h % kvh != 0 ||
      b * h > 65535 || s <= 0 || s > (int64_t{1} << 30)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Strides sq{sqb, sqh, sqs}, sk{skb, skh, sks}, sv{svb, svh, svs},
      so{sob, soh, sos};
  const int group = static_cast<int>(h / kvh);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nc = static_cast<int>(hd / 16);
  if (bf16) {
    return dispatch_flash_attention<__nv_bfloat16>(
        nc, q, k, v, o, sq, sk, sv, so, static_cast<int>(b),
        static_cast<int>(h), group, static_cast<int>(s), causal, window,
        scale, st);
  }
  return dispatch_flash_attention<float>(
      nc, q, k, v, o, sq, sk, sv, so, static_cast<int>(b),
      static_cast<int>(h), group, static_cast<int>(s), causal, window, scale,
      st);
}

int mk_ssd_scan(const void* states, const float* decays, void* h_prev,
                float* h_last, int64_t b, int64_t c, int64_t h, int64_t pn,
                int bf16, void* stream) {
  const int64_t tiles = (pn + kScanThreads - 1) / kScanThreads;
  if (b * h > 0x7fffffff || tiles > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(b * h), static_cast<unsigned>(tiles));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    ssd_scan_kernel<__nv_bfloat16><<<grid, kScanThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(states), decays,
        static_cast<__nv_bfloat16*>(h_prev), h_last, static_cast<int>(c),
        static_cast<int>(h), pn);
  } else {
    ssd_scan_kernel<float><<<grid, kScanThreads, 0, st>>>(
        static_cast<const float*>(states), decays,
        static_cast<float*>(h_prev), h_last, static_cast<int>(c),
        static_cast<int>(h), pn);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
