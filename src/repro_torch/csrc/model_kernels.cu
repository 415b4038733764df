// Hand-written Hopper (sm_90a) kernels of the model zoo's prefill:
// K4 flash_attention and K5 ssd_scan.
//
// Built by repro_torch/kernels/_build.py beside fedback_kernels.cu (one
// nvcc -c per source, started together, then linked into one shared
// library with a plain C interface, loaded with ctypes).  Every entry
// point launches on the stream it is given, allocates nothing, and
// returns the CUDA error of the launch so the Python wrapper can raise
// on a refused launch.  The wrappers check dtypes, shapes, strides and
// alignment before passing pointers.  No kernel is compiled with fast
// math.

#include <cuda.h>  // CUtensorMap and its enums; no libcuda link
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
// = 8.59e10 operations, 0.087 ms at 989 TFLOP/s bf16 on the tensor
// cores, against 84 MB of q/k/v/out, 0.025 ms at 3.35 TB/s: bound by
// operations.  Three instances, chosen by the wrapper before the launch
// (flash_attention.kernel_instance: dtype, strides and addresses):
//
// - bf16 (the served path): flash_attention_tc_kernel below, on the
//   tensor cores through wgmma.  Its note says what it does about the
//   bound.
// - fp32 whose tensors suit TMA (16-byte bases, strides in multiples of
//   4 elements): flash_attention_tf32x3_kernel, on the tensor cores in
//   3xTF32.  One TF32 product keeps 10 mantissa bits and misses the
//   fp32 checks (rtol 1e-4) by two orders of magnitude; three products
//   of split operands (big*big + big*small + small*big) keep 22 bits and
//   hold them.  Its note says how.
// - other fp32: flash_attention_kernel, fp32 SIMT FMAs from shared
//   memory.
//
// Masks are index predicates on absolute positions (ragged S, kv <= q
// causal, kv > q - window); a row masked so far contributes nothing
// (p = 0, corr = 1); l is floored at 1e-30.  Inputs may have any strides
// with a contiguous head dim, so the model's (B, S, H, hd) layout needs
// no transpose.
//
// SIMT instance: one block of 256 threads per (64-row query tile,
// batch*head), heaviest causal tiles first.  The block walks the 64-key
// tiles that the mask can reach — none right of the diagonal, none left
// of the window, as the Pallas grid's pl.when(reachable) — staging K and
// V in shared memory as fp32.  Each thread computes a 4x4 patch of the
// 64x64 score tile with fp32 FMAs on float4 reads (rows ty*4+i, keys
// tx+16j, rows padded by 4 floats so the 16 key rows of a half-warp fall
// on distinct banks), masks it with -inf, and four threads per row carry
// the online softmax's m and l; each thread then accumulates its 4 rows x
// hd/16 columns of P v in registers.  The probabilities stay fp32.
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
// K4, bf16 instance: flash_attention_tc_kernel, on the tensor cores.
//
// Design against the 8.59e10-operation bound (0.087 ms at 989 TFLOP/s):
// both products run as wgmma on bf16 operands with fp32 accumulators in
// registers, and the tensor memory accelerator (TMA) copies the next
// tile while this one is computed.
//
// - A block of 256 threads (two consumer warpgroups) owns a 128-row
//   query tile of one (batch, head): warpgroup w the rows 64w .. 64w+63.
//   Both share each 64-key K/V tile, which halves the L2 -> shared
//   traffic per operation against a 64-row block.  Grid (q-tiles, B*H),
//   the q-tile index reversed, so each head's heaviest causal tiles
//   start first and the blocks resident at once share a few heads' K/V
//   in L2.
// - S = Q K^T: hd/16 wgmma m64n64k16 (5 at hd = 80), Q (A) and K (B)
//   both from shared memory, K-major.  Q is copied once.
// - The online softmax runs in registers, in the accumulator layout: a
//   thread holds 2 rows x 16 keys, a row spread over a quad of lanes and
//   reduced with two shuffles.  The scale is folded into the exponent as
//   hd^-1/2 * log2 e and 2^x runs on the special-function unit
//   (ex2.approx); m and l stay in fp32; a row masked so far gets p = 0
//   and corr = 1.  Only the tiles that cross the diagonal, the window
//   edge or the ragged end of S evaluate the mask.
// - P is rounded to bf16 in registers, where the accumulator layout of S
//   is the A-fragment layout of the next product, and O += P V runs as 4
//   wgmma m64n(hd)k16 with A from registers and V (B) from shared memory
//   in its natural MN-major layout (transpose bit set).  Rounding P to
//   bf16 before P V is where the JAX blockwise_attention rounds it; the
//   Pallas kernel keeps P in fp32, the SIMT instance too, the 3xTF32
//   one to 22 bits (ROADMAP D4).
// - K/V tiles arrive by TMA into a ring of two shared-memory slots, each
//   with an mbarrier that counts the bytes in.  At the top of tile t
//   every thread waits for tile t's bytes, then one block barrier says
//   every warpgroup is done with tile t - 1, whose slot takes the copy of
//   tile t + 1 at once, so that copy overlaps tile t's products and no
//   thread computes an address.  Rows past S arrive as zeros.
//
// Shared-memory layout, and why: a bf16 row is 2*hd bytes, 160 at
// hd = 80, wider than the 128-byte span of the 128B swizzle and not a
// multiple of it.  The head dim is padded to a multiple of 64 in shared
// memory: a tile is kRegions = ceil(hd/64) regions of 64 head columns,
// each its rows x 128 bytes, 128B-swizzled, written by one TMA box {64
// columns, rows} of a 4-D tensor map {hd, S, heads, B}; the columns past
// hd (80 .. 127 at hd = 80) are out of the map's bounds and arrive as
// zeros.  The padding costs shared memory (96 KB a block at hd = 80, two
// blocks an SM) but no wgmma k-step: the products stop at column hd (5
// k-steps at hd = 80).  Narrower choices were measured first on the H100
// and dropped: a no-swizzle layout needs 16-byte rows, so its copies —
// 16-byte cp.async by every thread, or TMA boxes 16 bytes wide — moved
// the same bytes in pieces too small for the memory system, and the
// copies, not the products, set the pace.  wgmma itself read both
// layouts at the same rate in a microbenchmark.
// Descriptors (byte offsets, >> 4 in the descriptor; layout type 1):
//   Q, K (K-major):  SBO = 1024 (next 8 rows), LBO unused; a k16 step
//                    adds 32 bytes within a 128-byte row, and the fifth
//                    step starts in region 1.
//   V (MN-major):    LBO = 64 keys x 128 (next region, head columns
//                    64 ..), SBO = 1024 (next 8 keys); a k16 step adds
//                    16 rows (2048 bytes).
// A tensor map needs a 16-byte-aligned base and every batch, head and
// sequence stride a multiple of 16 bytes (8 elements); the wrapper's
// check_kernel_args holds that rule and raises on any tensor that breaks
// it (it never copies one), so the library does not check it again (a
// map the driver refuses to encode still fails the launch).  The maps
// are encoded per call on the host through the driver's
// cuTensorMapEncodeTiled, fetched with cudaGetDriverEntryPoint (so the
// library needs no link to libcuda), and passed as __grid_constant__
// parameters.
//
// Also measured on the H100 and dropped: a third ring slot (128 KB a
// block, one block an SM: slower); a producer warp with full/empty
// barriers in place of the block barrier (288 threads cap the registers
// at 96 for two blocks an SM, and the spills made it slower); issuing
// tile t-1's P V behind tile t's S = Q K^T (more live registers, spills,
// slower); the boxes of a tile issued by four warps instead of thread 0
// (no change).
constexpr int kTcRows = 128;  // query rows per block: two warpgroups
constexpr int kTcKeys = 64;   // keys per tile
constexpr int kTcThreads = 256;
constexpr int kTcStages = 2;  // K/V ring slots

template <int kNc>
struct TcLayout {
  static constexpr int kRegions = (kNc + 3) / 4;  // 64-column regions
  static constexpr int kQBytes = kRegions * kTcRows * 128;
  static constexpr int kTileBytes = kRegions * kTcKeys * 128;  // K or V
  static constexpr int kStageBytes = 2 * kTileBytes;            // K, then V
  // + 1024: the base is rounded up to the 128B swizzle's 1024-byte period
  static constexpr int kSmemBytes =
      kQBytes + kTcStages * kStageBytes + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Arms a barrier for one arrival that brings `bytes` with it.
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// Waits for the phase of parity `parity` to complete.  A wait that
// outlasts 2^32 cycles (seconds) traps, so a lost copy fails the launch
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long start = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1ll << 32)) __trap();
  }
}

// One TMA box {64, rows, 1, 1} of a map {hd, S, heads, B} at (col, row,
// head, batch): head columns col .. col+63 of `rows` rows, as rows of 128
// bytes, 128B-swizzled (columns past hd arrive as zeros), on bar.
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map,
                                        int col, int row, int head,
                                        int batch, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(head),
      "r"(batch), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of registers that an
// asynchronous product writes across it.
template <int kN>
__device__ __forceinline__ void fence_regs(float (&d)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor of a 128B-swizzled layout (type 1);
// start addresses inside a 1024-byte swizzle period keep base offset 0.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (uint64_t{1} << 62);
}

// 2^x on the special-function unit: about 2 ulp, results below 2^-126
// flushed to 0 (a probability that small adds nothing to a bf16 P).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// S (64 x 64, fp32) += A (64 x 16) * B (64 x 16)^T, A and B from shared
// memory, both K-major.  Accumulator element i of a thread lies at row
// 16*warp + lane/4 + 8*((i/2)%2), column 8*(i/4) + 2*(lane%4) + i%2.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t da,
                                                   uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// O (64 x 16*kNc, fp32) += P (64 x 16, bf16 in registers, the
// A-fragment layout) * V (16 x 16*kNc) from shared memory, MN-major
// (transpose bit set).
template <int kNc>
__device__ __forceinline__ void wgmma_pv(float (&d)[8 * kNc],
                                         const uint32_t (&a)[4], uint64_t db);

// One macro writes every instance of wgmma_pv.  The accumulators
// d[0 .. 8*kNc) are asm operands %0 .. %(8*kNc - 1), eight per row of
// PV_OPS; the A fragment, V's descriptor and the scale-d flag are the
// six operands after them, the first six numbers of row kNc.
#define PV_OPS_0(M) M(0, 1, 2, 3, 4, 5, 6, 7)
#define PV_OPS_1(M) M(8, 9, 10, 11, 12, 13, 14, 15)
#define PV_OPS_2(M) M(16, 17, 18, 19, 20, 21, 22, 23)
#define PV_OPS_3(M) M(24, 25, 26, 27, 28, 29, 30, 31)
#define PV_OPS_4(M) M(32, 33, 34, 35, 36, 37, 38, 39)
#define PV_OPS_5(M) M(40, 41, 42, 43, 44, 45, 46, 47)
#define PV_OPS_6(M) M(48, 49, 50, 51, 52, 53, 54, 55)
#define PV_OPS_7(M) M(56, 57, 58, 59, 60, 61, 62, 63)
#define PV_OPS_8(M) M(64, 65, 66, 67, 68, 69, 70, 71)
// Eight accumulators, as references in the asm string and as operands.
#define PV_REFS(i0, i1, i2, i3, i4, i5, i6, i7)                             \
  "%" #i0 ", %" #i1 ", %" #i2 ", %" #i3 ", %" #i4 ", %" #i5 ", %" #i6      \
  ", %" #i7
#define PV_OUTS(i0, i1, i2, i3, i4, i5, i6, i7)                             \
  "+f"(d[i0]), "+f"(d[i1]), "+f"(d[i2]), "+f"(d[i3]), "+f"(d[i4]),         \
      "+f"(d[i5]), "+f"(d[i6]), "+f"(d[i7])
// The operands after the accumulators: scale-d, then A and V's
// descriptor.
#define PV_SCALE(i0, i1, i2, i3, i4, i5, i6, i7)                            \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %" #i5 ", 0;\n"
#define PV_AB(i0, i1, i2, i3, i4, i5, i6, i7)                               \
  "{%" #i0 ", %" #i1 ", %" #i2 ", %" #i3 "}, %" #i4 ", p, 1, 1, 1;\n}\n"
#define PV_REFS_1 PV_OPS_0(PV_REFS)
#define PV_REFS_2 PV_REFS_1 ", " PV_OPS_1(PV_REFS)
#define PV_REFS_3 PV_REFS_2 ", " PV_OPS_2(PV_REFS)
#define PV_REFS_4 PV_REFS_3 ", " PV_OPS_3(PV_REFS)
#define PV_REFS_5 PV_REFS_4 ", " PV_OPS_4(PV_REFS)
#define PV_REFS_6 PV_REFS_5 ", " PV_OPS_5(PV_REFS)
#define PV_REFS_7 PV_REFS_6 ", " PV_OPS_6(PV_REFS)
#define PV_REFS_8 PV_REFS_7 ", " PV_OPS_7(PV_REFS)
#define PV_OUTS_1 PV_OPS_0(PV_OUTS)
#define PV_OUTS_2 PV_OUTS_1, PV_OPS_1(PV_OUTS)
#define PV_OUTS_3 PV_OUTS_2, PV_OPS_2(PV_OUTS)
#define PV_OUTS_4 PV_OUTS_3, PV_OPS_3(PV_OUTS)
#define PV_OUTS_5 PV_OUTS_4, PV_OPS_4(PV_OUTS)
#define PV_OUTS_6 PV_OUTS_5, PV_OPS_5(PV_OUTS)
#define PV_OUTS_7 PV_OUTS_6, PV_OPS_6(PV_OUTS)
#define PV_OUTS_8 PV_OUTS_7, PV_OPS_7(PV_OUTS)
#define PV_INSTANCE(N, WIDTH)                                               \
  template <>                                                               \
  __device__ __forceinline__ void wgmma_pv<N>(                              \
      float (&d)[8 * N], const uint32_t (&a)[4], uint64_t db) {            \
    asm volatile(PV_OPS_##N(PV_SCALE)                                       \
                 "wgmma.mma_async.sync.aligned.m64n" #WIDTH                \
                 "k16.f32.bf16.bf16 {" PV_REFS_##N "}, "                   \
                 PV_OPS_##N(PV_AB)                                          \
                 : PV_OUTS_##N                                              \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),    \
                   "r"(1));                                                 \
  }
PV_INSTANCE(1, 16)
PV_INSTANCE(2, 32)
PV_INSTANCE(3, 48)
PV_INSTANCE(4, 64)
PV_INSTANCE(5, 80)
PV_INSTANCE(6, 96)
PV_INSTANCE(7, 112)
PV_INSTANCE(8, 128)


template <int kNc>
__global__ void __launch_bounds__(kTcThreads, kNc <= 6 ? 2 : 1)
flash_attention_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          __nv_bfloat16* __restrict__ o, Strides so, int h,
                          int group, int s, int causal, int window,
                          float scale_log2) {
  using L = TcLayout<kNc>;
  constexpr int kOut = 8 * kNc;  // O accumulators per thread
  extern __shared__ __align__(1024) unsigned char tc_smem[];
  __shared__ __align__(8) uint64_t bars[kTcStages + 1];  // slots, then Q
  const uint32_t q_s = (smem_u32(tc_smem) + 1023) & ~1023u;
  const uint32_t ring = q_s + L::kQBytes;
  const uint32_t bar0 = smem_u32(bars);

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int n_qt = (s + kTcRows - 1) / kTcRows;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * kTcRows;
  const int bh = blockIdx.y;
  const int b = bh / h;
  const int head = bh % h;
  const int kv_head = head / group;

  // Key tiles: the block copies [t_lo, t_hi); this warpgroup, rows
  // wq0 .. wq_last, computes [w_lo, w_hi).
  const int n_kt = (s + kTcKeys - 1) / kTcKeys;
  auto first_tile = [&](int row) {
    return window > 0 && row - window + 1 > 0 ? (row - window + 1) / kTcKeys
                                              : 0;
  };
  auto end_tile = [&](int row) {
    return causal ? min(n_kt, row / kTcKeys + 1) : n_kt;
  };
  const int t_lo = first_tile(q0);
  const int t_hi = end_tile(min(q0 + kTcRows, s) - 1);
  const int wq0 = q0 + 64 * wg;
  const int wq_last = min(wq0 + 63, s - 1);
  const int w_lo = first_tile(wq0);
  const int w_hi = wq0 < s ? end_tile(wq_last) : w_lo;

  // Tile t lives in slot (t - t_lo) % kTcStages; its k-th use of the slot
  // completes phase k of the slot's barrier (the bytes of K and V in).
  // Thread 0 issues every copy: a tile is kRegions boxes of K, then V.
  const uint32_t bar_q = bar0 + 8 * kTcStages;
  auto copy_kv = [&](int t, int slot) {
    const uint32_t st = ring + slot * L::kStageBytes;
    const uint32_t bar = bar0 + 8 * slot;
    mbar_expect(bar, L::kStageBytes);
#pragma unroll
    for (int r = 0; r < L::kRegions; ++r) {
      tma_box(st + r * kTcKeys * 128, &tm_k, 64 * r, t * kTcKeys, kv_head,
              b, bar);
      tma_box(st + L::kTileBytes + r * kTcKeys * 128, &tm_v, 64 * r,
              t * kTcKeys, kv_head, b, bar);
    }
  };
  if (tid == 0) {
    for (int i = 0; i <= kTcStages; ++i) mbar_init(bar0 + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the barriers are initialised
  if (tid == 0) {
    mbar_expect(bar_q, L::kQBytes);
#pragma unroll
    for (int r = 0; r < L::kRegions; ++r) {
      tma_box(q_s + r * kTcRows * 128, &tm_q, 64 * r, q0, head, b, bar_q);
    }
    for (int i = 0; i < kTcStages - 1 && t_lo + i < t_hi; ++i) {
      copy_kv(t_lo + i, i);
    }
  }

  // This thread's rows are r0 and r0 + 8; in each 8-key (or 8-column)
  // block it holds columns col0 and col0 + 1.
  const int r0 = wq0 + 16 * warp + (lane >> 2);
  const int col0 = 2 * (lane & 3);
  const uint32_t q_wg = q_s + wg * 64 * 128;  // this warpgroup's Q rows
  float acc[kOut];
#pragma unroll
  for (int i = 0; i < kOut; ++i) acc[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // this thread's share; the quad's at the end
  mbar_wait(bar_q, 0);

  // One key tile t (K and V in the ring slot at `stage`) for this
  // warpgroup's 64 rows.
  auto attend_tile = [&](int t, uint32_t stage) {
    // S = Q K^T.
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kNc; ++kk) {  // columns 16kk .. 16kk+15
      const uint32_t col = (kk % 4) * 32;  // 32 bytes into the row
      wgmma_m64n64k16_ss(
          sc, gmma_desc(q_wg + (kk / 4) * kTcRows * 128 + col, 16, 1024),
          gmma_desc(stage + (kk / 4) * kTcKeys * 128 + col, 16, 1024), 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // The mask, on the tiles that cross the ragged end of S, the diagonal
    // or the window edge for some row of this warpgroup.
    const int k0 = t * kTcKeys;
    if (k0 + kTcKeys > s || (causal && k0 + kTcKeys - 1 > wq0) ||
        (window > 0 && k0 <= wq_last - window)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = k0 + 8 * (i >> 2) + col0 + (i & 1);
        const int row = r0 + 8 * ((i >> 1) & 1);
        bool ok = key < s;
        if (causal) ok = ok && key <= row;
        if (window > 0) ok = ok && key > row - window;
        if (!ok) sc[i] = -INFINITY;
      }
    }

    // Online softmax in the log2 domain.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    }
    float mu[2], corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r] * scale_log2);
      const bool empty = m_new == -INFINITY;  // every key so far masked
      mu[r] = empty ? 0.f : m_new;
      corr[r] = empty ? 1.f : fast_exp2(m_run[r] - m_new);
      m_run[r] = m_new;
    }
    // P in bf16, straight into the A fragments of the next product: keys
    // 16kk .. 16kk+15 are accumulator elements 8kk .. 8kk+7.
    uint32_t pa[4][4];
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p0 = fast_exp2(fmaf(sc[4 * j], scale_log2, -mu[0]));
      const float p1 = fast_exp2(fmaf(sc[4 * j + 1], scale_log2, -mu[0]));
      const float p2 = fast_exp2(fmaf(sc[4 * j + 2], scale_log2, -mu[1]));
      const float p3 = fast_exp2(fmaf(sc[4 * j + 3], scale_log2, -mu[1]));
      sum[0] += p0 + p1;
      sum[1] += p2 + p3;
      pa[j >> 1][2 * (j & 1)] = pack_bf16(p0, p1);
      pa[j >> 1][2 * (j & 1) + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * corr[r] + sum[r];
#pragma unroll
    for (int i = 0; i < kOut; ++i) acc[i] *= corr[(i >> 1) & 1];

    // O += P V.
    wgmma_fence();
    const uint32_t v_s = stage + L::kTileBytes;
#pragma unroll
    for (int kk = 0; kk < kTcKeys / 16; ++kk) {
      wgmma_pv<kNc>(acc, pa[kk],
                    gmma_desc(v_s + kk * 16 * 128, kTcKeys * 128, 1024));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
  };

  int slot = 0;        // ring slot of tile t
  uint32_t phase = 0;  // parity of the slot's use by tile t
  for (int t = t_lo; t < t_hi; ++t) {
    const uint32_t stage = ring + slot * L::kStageBytes;
    mbar_wait(bar0 + 8 * slot, phase);  // tile t has landed
    __syncthreads();  // and every warpgroup is done with tile t - 1
    // Tile t + kTcStages - 1 goes into the slot that tile t - 1 left.
    if (tid == 0 && t + kTcStages - 1 < t_hi) {
      copy_kv(t + kTcStages - 1, slot == 0 ? kTcStages - 1 : slot - 1);
    }
    if (t >= w_lo && t < w_hi) attend_tile(t, stage);
    if (++slot == kTcStages) {
      slot = 0;
      phase ^= 1;
    }
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = 1.f / fmaxf(l, 1e-30f);
  }
  __nv_bfloat16* ob = o + b * so.b + head * so.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= s) continue;
    __nv_bfloat16* orow = ob + static_cast<int64_t>(row) * so.s + col0;
#pragma unroll
    for (int j = 0; j < 2 * kNc; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r] * inv[r],
                                acc[4 * j + 2 * r + 1] * inv[r]);
    }
  }
}

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                   cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, through the runtime (no libcuda
// link); null if the driver does not have it.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess) {
      return static_cast<EncodeTiledFn>(nullptr);
    }
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// A 4-D map {d0, d1, d2, d3} of bf16 or fp32 elements with element
// strides s1, s2, s3 (d0 contiguous), read in 128B-swizzled boxes of one
// 128-byte row of d0 (64 bf16 or 32 fp32 elements) by `rows` of d1.
template <typename T>
bool encode_map(CUtensorMap* map, const void* base, int64_t d0, int64_t d1,
                int64_t d2, int64_t d3, int64_t s1, int64_t s2, int64_t s3,
                int rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  constexpr bool kBf16 = sizeof(T) == 2;
  const cuuint64_t dims[4] = {
      static_cast<cuuint64_t>(d0), static_cast<cuuint64_t>(d1),
      static_cast<cuuint64_t>(d2), static_cast<cuuint64_t>(d3)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(s1) * sizeof(T),
                                 static_cast<cuuint64_t>(s2) * sizeof(T),
                                 static_cast<cuuint64_t>(s3) * sizeof(T)};
  const cuuint32_t box[4] = {128 / sizeof(T),
                             static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map,
                kBf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                      : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                4, const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int kNc>
int launch_flash_attention_tc(const void* q, const void* k, const void* v,
                              void* o, Strides sq, Strides sk, Strides sv,
                              Strides so, int b, int h, int kvh, int s,
                              int causal, int window, float scale_log2,
                              cudaStream_t stream) {
  constexpr int hd = 16 * kNc;
  CUtensorMap tm_q, tm_k, tm_v;
  using bf16 = __nv_bfloat16;
  if (!encode_map<bf16>(&tm_q, q, hd, s, h, b, sq.s, sq.h, sq.b, kTcRows) ||
      !encode_map<bf16>(&tm_k, k, hd, s, kvh, b, sk.s, sk.h, sk.b,
                        kTcKeys) ||
      !encode_map<bf16>(&tm_v, v, hd, s, kvh, b, sv.s, sv.h, sv.b,
                        kTcKeys)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int smem = TcLayout<kNc>::kSmemBytes;
  auto kernel = flash_attention_tc_kernel<kNc>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s + kTcRows - 1) / kTcRows, b * h);
  kernel<<<grid, kTcThreads, smem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), so, h, h / kvh, s,
      causal, window, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_flash_attention_tc(int nc, const void* q, const void* k,
                                const void* v, void* o, Strides sq,
                                Strides sk, Strides sv, Strides so, int b,
                                int h, int kvh, int s, int causal,
                                int window, float scale_log2,
                                cudaStream_t stream) {
#define FA_TC_CASE(N)                                                       \
  case N:                                                                   \
    return launch_flash_attention_tc<N>(q, k, v, o, sq, sk, sv, so, b, h,  \
                                        kvh, s, causal, window,            \
                                        scale_log2, stream);
  switch (nc) {
    FA_TC_CASE(1)
    FA_TC_CASE(2)
    FA_TC_CASE(3)
    FA_TC_CASE(4)
    FA_TC_CASE(5)
    FA_TC_CASE(6)
    FA_TC_CASE(7)
    FA_TC_CASE(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FA_TC_CASE
}

// ---------------------------------------------------------------------
// K4, fp32 instance on the tensor cores: flash_attention_tf32x3_kernel.
//
// Bound at (4, 32, 2048, 80) fp32 causal: the 8.59e10 operations of
// QK^T and PV, done three times over in TF32 (below), 2.58e11 at 494.7
// TFLOP/s dense TF32 = 0.521 ms; the 335.5 MB of fp32 q/k/v/out take
// 0.100 ms at 3.35 TB/s: bound by operations.  The SIMT instance above
// is bound at 1.28 ms (one product at 67 TFLOP/s fp32).
//
// 3xTF32.  A TF32 operand keeps 10 explicit mantissa bits; one TF32
// product misses the fp32 checks (rtol 1e-4) by two orders of
// magnitude.  Each operand x is split into big = tf32(x) and small =
// tf32(x - big) (cvt.rna, written out, never left to the tensor core's
// own truncation), and each product is small*big + big*small + big*big
// into one fp32 accumulator, the small cross terms issued first as
// CUTLASS's FastF32 does: 22 bits of each operand, within the fp32
// tolerance (tests/test_torch_tf32x3.py emulates it on the CPU).
//
// Layout.  TF32 wgmma takes no transpose bit: both operands must be
// K-major.  Q (A of S = Q K^T) and K (B) are, as they lie; V is not, so
// a pre-pass, tf32x3_split_kernel, writes K's big and small parts and
// V^T's (hd rows of keys) into scratch the wrapper allocates, once per
// call (0.5 GB moved at the serve shape).  In V^T the keys of each group
// of 8 are stored in the order 0 2 4 6 1 3 5 7: a TF32 A fragment holds
// columns t and t+4 of each 8-wide k-slice (t = lane % 4), the S
// accumulator gives the lane columns 2t and 2t+1, and with that order
// P goes from the one to the other in registers, without a shuffle.
//
// The block is the bf16 instance's: two consumer warpgroups own 128
// query rows of one (batch, head), heaviest causal tiles first, the
// diagonal and the window skip whole tiles, masks are index predicates,
// and K/V tiles arrive by TMA into a two-slot mbarrier ring,
// 128B-swizzled (one box row is 32 floats; hd 80 pads to 96 in shared
// memory, but the products stop at column hd).  Q is copied once by TMA
// into the second slot's space, and each thread reads its A fragments
// from there and splits them into registers (hd/2 + hd/2 a thread: 80
// at hd 80) before that slot takes its first tile.  A stage holds K big
// and small (kRegions x keys x 128 B each) and V^T big and small (keys/32
// x hd x 128 B each): 88 KB at hd 80, so one block a SM.  Up to hd 96
// a tile has 64 keys; at hd 112 and 128 it has 32, which keeps two
// stages in shared memory and S and P in fewer registers.
// Products per tile and warpgroup (64 keys, hd 80): S as 30 wgmma
// m64n64k8 (10 k-steps x 3), then O += P V as 24 wgmma m64n80k8 (8 x
// 3), A from registers, B by descriptor (K-major, SBO = 1024: the next
// 8 rows; a k8 step is 32 bytes within a 128-byte row, the fifth starts
// the next region).  The online softmax is the bf16 instance's (scale
// folded into ex2.approx, m and l in fp32); P stays fp32 and is split
// in registers.
//
// The tensor maps need 16-byte-aligned bases and strides that are
// multiples of 16 bytes (4 floats): the wrapper sends every other fp32
// input to the SIMT instance by that rule (kernel_instance), before the
// launch; a failed launch here raises.
constexpr int kSplitKeys = 64;  // keys per block of the pre-pass
constexpr int kSplitThreads = 256;

__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t u;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(u) : "f"(x));
  return __uint_as_float(u);
}

// (big, small) of x as 32-bit A-fragment registers.
__device__ __forceinline__ void tf32_split(float x, uint32_t& big,
                                           uint32_t& small) {
  const float b = tf32_rna(x);
  big = __float_as_uint(b);
  small = __float_as_uint(tf32_rna(x - b));
}

// K (B, KvH, S, hd) -> kx = [big | small], each (B*KvH, S, hd);
// V -> vtx = [big | small], each (B*KvH, hd, S8), keys 0 2 4 6 1 3 5 7
// within each group of 8, zero past S.  A block: 64 keys of one
// (batch, kv head); float4 reads of K and V, V staged in shared memory
// for the transpose.
__global__ void __launch_bounds__(kSplitThreads)
tf32x3_split_kernel(const float* __restrict__ k, const float* __restrict__ v,
                    Strides sk, Strides sv, float* __restrict__ kx,
                    float* __restrict__ vtx, int kvh, int s, int s8, int hd) {
  __shared__ float vs[kSplitKeys * (128 + 1)];
  const int ld = hd + 1;  // odd: the transposed reads spread over banks
  const int k0 = blockIdx.x * kSplitKeys;
  const int64_t bh = blockIdx.y;
  const int64_t nbh = gridDim.y;
  const int64_t b = bh / kvh, head = bh % kvh;
  const float* kb = k + b * sk.b + head * sk.h;
  const float* vb = v + b * sv.b + head * sv.h;
  float* k_big = kx + bh * s * hd;
  float* k_small = k_big + nbh * s * hd;
  const int n4 = hd / 4;
  for (int i = threadIdx.x; i < kSplitKeys * n4; i += kSplitThreads) {
    const int r = i / n4, c = 4 * (i % n4);
    const int key = k0 + r;
    float4 vv = make_float4(0.f, 0.f, 0.f, 0.f);
    if (key < s) {
      const float4 kk = __ldg(reinterpret_cast<const float4*>(
          kb + key * sk.s + c));
      vv = __ldg(reinterpret_cast<const float4*>(vb + key * sv.s + c));
      float4 big, small;
      big.x = tf32_rna(kk.x);
      big.y = tf32_rna(kk.y);
      big.z = tf32_rna(kk.z);
      big.w = tf32_rna(kk.w);
      small.x = tf32_rna(kk.x - big.x);
      small.y = tf32_rna(kk.y - big.y);
      small.z = tf32_rna(kk.z - big.z);
      small.w = tf32_rna(kk.w - big.w);
      const int64_t off = static_cast<int64_t>(key) * hd + c;
      *reinterpret_cast<float4*>(k_big + off) = big;
      *reinterpret_cast<float4*>(k_small + off) = small;
    }
    float* row = vs + r * ld + c;
    row[0] = vv.x;
    row[1] = vv.y;
    row[2] = vv.z;
    row[3] = vv.w;
  }
  __syncthreads();
  float* v_big = vtx + bh * hd * s8;
  float* v_small = v_big + nbh * hd * s8;
  for (int i = threadIdx.x; i < hd * kSplitKeys; i += kSplitThreads) {
    const int d = i / kSplitKeys, pos = i % kSplitKeys;
    if (k0 + pos >= s8) continue;
    const int r = (pos & ~7) + 2 * (pos & 3) + ((pos >> 2) & 1);
    const float x = vs[r * ld + d];
    const float big = tf32_rna(x);
    const int64_t off = static_cast<int64_t>(d) * s8 + k0 + pos;
    v_big[off] = big;
    v_small[off] = tf32_rna(x - big);
  }
}

template <int kNc>
struct Tf32Layout {
  static constexpr int kHd = 16 * kNc;
  static constexpr int kKeys = kNc <= 6 ? 64 : 32;  // keys per tile
  static constexpr int kRegions = (kHd + 31) / 32;   // of Q and K
  static constexpr int kKRegion = kKeys * 128;       // 32 head columns
  static constexpr int kKBytes = kRegions * kKRegion;  // K big or small
  static constexpr int kVRegion = kHd * 128;           // 32 keys of V^T
  static constexpr int kVBytes = (kKeys / 32) * kVRegion;
  static constexpr int kStageBytes = 2 * kKBytes + 2 * kVBytes;
  static constexpr int kQBytes = kRegions * kTcRows * 128;
  // slot 0, then slot 1 (which Q occupies first), + 1024 for the
  // swizzle period's alignment
  static constexpr int kSmemBytes =
      kStageBytes + (kQBytes > kStageBytes ? kQBytes : kStageBytes) + 1024;
};

// D (64 x 16N, fp32) += A (64 x 8, TF32 in registers, the A-fragment
// layout) * B (16N x 8)^T, B from shared memory, K-major: S = Q K^T at
// N = keys/16, O += P V^T^T at N = kNc.
template <int kN>
__device__ __forceinline__ void wgmma_tf32(float (&d)[8 * kN],
                                           const uint32_t (&a)[4],
                                           uint64_t db);
#define TF32_AB(i0, i1, i2, i3, i4, i5, i6, i7)                             \
  "{%" #i0 ", %" #i1 ", %" #i2 ", %" #i3 "}, %" #i4 ", p, 1, 1;\n}\n"
#define TF32_INSTANCE(N, WIDTH)                                             \
  template <>                                                               \
  __device__ __forceinline__ void wgmma_tf32<N>(                            \
      float (&d)[8 * N], const uint32_t (&a)[4], uint64_t db) {            \
    asm volatile(PV_OPS_##N(PV_SCALE)                                       \
                 "wgmma.mma_async.sync.aligned.m64n" #WIDTH                \
                 "k8.f32.tf32.tf32 {" PV_REFS_##N "}, "                    \
                 PV_OPS_##N(TF32_AB)                                        \
                 : PV_OUTS_##N                                              \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),    \
                   "r"(1));                                                 \
  }
TF32_INSTANCE(1, 16)
TF32_INSTANCE(2, 32)
TF32_INSTANCE(3, 48)
TF32_INSTANCE(4, 64)
TF32_INSTANCE(5, 80)
TF32_INSTANCE(6, 96)
TF32_INSTANCE(7, 112)
TF32_INSTANCE(8, 128)

__device__ __forceinline__ float ld_shared_f32(uint32_t addr) {
  float x;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(x) : "r"(addr));
  return x;
}

template <int kNc>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_attention_tf32x3_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_kb,
                              const __grid_constant__ CUtensorMap tm_ks,
                              const __grid_constant__ CUtensorMap tm_vb,
                              const __grid_constant__ CUtensorMap tm_vs,
                              float* __restrict__ o, Strides so, int h,
                              int group, int s, int causal, int window,
                              float scale_log2) {
  using L = Tf32Layout<kNc>;
  constexpr int kKeys = L::kKeys;
  constexpr int kOut = 8 * kNc;    // O accumulators per thread
  constexpr int kSc = kKeys / 2;   // S accumulators per thread
  constexpr int kKq = 2 * kNc;     // k8 steps over the head dim
  constexpr int kKp = kKeys / 8;   // k8 steps over a tile's keys
  extern __shared__ __align__(1024) unsigned char x3_smem[];
  __shared__ __align__(8) uint64_t bars[3];  // slot 0, slot 1, Q
  const uint32_t ring = (smem_u32(x3_smem) + 1023) & ~1023u;
  const uint32_t q_s = ring + L::kStageBytes;  // slot 1's space, at first
  const uint32_t bar0 = smem_u32(bars);
  const uint32_t bar_q = bar0 + 16;

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int n_qt = (s + kTcRows - 1) / kTcRows;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * kTcRows;
  const int bh = blockIdx.y;
  const int b = bh / h;
  const int head = bh % h;
  const int kv_head = head / group;

  // Key tiles: the block copies [t_lo, t_hi); this warpgroup, rows
  // wq0 .. wq_last, computes [w_lo, w_hi).
  const int n_kt = (s + kKeys - 1) / kKeys;
  auto first_tile = [&](int row) {
    return window > 0 && row - window + 1 > 0 ? (row - window + 1) / kKeys
                                              : 0;
  };
  auto end_tile = [&](int row) {
    return causal ? min(n_kt, row / kKeys + 1) : n_kt;
  };
  const int t_lo = first_tile(q0);
  const int t_hi = end_tile(min(q0 + kTcRows, s) - 1);
  const int wq0 = q0 + 64 * wg;
  const int wq_last = min(wq0 + 63, s - 1);
  const int w_lo = first_tile(wq0);
  const int w_hi = wq0 < s ? end_tile(wq_last) : w_lo;

  // A stage: K big, K small, V^T big, V^T small.  Thread 0 issues every
  // copy.
  auto copy_kv = [&](int t, int slot) {
    const uint32_t st = ring + slot * L::kStageBytes;
    const uint32_t bar = bar0 + 8 * slot;
    mbar_expect(bar, L::kStageBytes);
#pragma unroll
    for (int r = 0; r < L::kRegions; ++r) {
      tma_box(st + r * L::kKRegion, &tm_kb, 32 * r, t * kKeys, kv_head, b,
              bar);
      tma_box(st + L::kKBytes + r * L::kKRegion, &tm_ks, 32 * r, t * kKeys,
              kv_head, b, bar);
    }
#pragma unroll
    for (int r = 0; r < kKeys / 32; ++r) {
      const uint32_t vt = st + 2 * L::kKBytes + r * L::kVRegion;
      tma_box(vt, &tm_vb, t * kKeys + 32 * r, 0, kv_head, b, bar);
      tma_box(vt + L::kVBytes, &tm_vs, t * kKeys + 32 * r, 0, kv_head, b,
              bar);
    }
  };
  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bar0 + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the barriers are initialised
  if (tid == 0) {
    mbar_expect(bar_q, L::kQBytes);
#pragma unroll
    for (int r = 0; r < L::kRegions; ++r) {
      tma_box(q_s + r * kTcRows * 128, &tm_q, 32 * r, q0, head, b, bar_q);
    }
    if (t_lo < t_hi) copy_kv(t_lo, 0);
  }

  // This thread's rows are r0 and r0 + 8; in each 8-key (or 8-column)
  // block of an accumulator it holds columns col0 and col0 + 1, and in
  // each k-slice of an A fragment columns lane%4 and lane%4 + 4.
  const int r0 = wq0 + 16 * warp + (lane >> 2);
  const int col0 = 2 * (lane & 3);
  uint32_t qb[kKq][4], qsm[kKq][4];  // Q's A fragments: big, small
  mbar_wait(bar_q, 0);
  {
    const int row_t = 64 * wg + 16 * warp + (lane >> 2);  // in the tile
#pragma unroll
    for (int kk = 0; kk < kKq; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // a0 (g, t) a1 (g+8, t) a2, a3 (t+4)
        const int row = row_t + 8 * (e & 1);
        const int col = 8 * kk + (lane & 3) + 4 * (e >> 1);
        const uint32_t addr = q_s + (col / 32) * (kTcRows * 128) +
                              row * 128 +
                              (((col % 32) * 4) ^ ((row & 7) << 4));
        tf32_split(ld_shared_f32(addr), qb[kk][e], qsm[kk][e]);
      }
    }
  }
  float acc[kOut];
#pragma unroll
  for (int i = 0; i < kOut; ++i) acc[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // this thread's share; the quad's at the end

  auto attend_tile = [&](int t, uint32_t stage) {
    // S = Q K^T: the small cross terms, then big * big.
    float sc[kSc];
#pragma unroll
    for (int i = 0; i < kSc; ++i) sc[i] = 0.f;
    const uint32_t kb_s = stage, ks_s = stage + L::kKBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKq; ++kk) {
      const uint32_t off = (kk / 4) * L::kKRegion + (kk % 4) * 32;
      wgmma_tf32<kKeys / 16>(sc, qsm[kk], gmma_desc(kb_s + off, 16, 1024));
      wgmma_tf32<kKeys / 16>(sc, qb[kk], gmma_desc(ks_s + off, 16, 1024));
    }
#pragma unroll
    for (int kk = 0; kk < kKq; ++kk) {
      const uint32_t off = (kk / 4) * L::kKRegion + (kk % 4) * 32;
      wgmma_tf32<kKeys / 16>(sc, qb[kk], gmma_desc(kb_s + off, 16, 1024));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    const int k0 = t * kKeys;
    if (k0 + kKeys > s || (causal && k0 + kKeys - 1 > wq0) ||
        (window > 0 && k0 <= wq_last - window)) {
#pragma unroll
      for (int i = 0; i < kSc; ++i) {
        const int key = k0 + 8 * (i >> 2) + col0 + (i & 1);
        const int row = r0 + 8 * ((i >> 1) & 1);
        bool ok = key < s;
        if (causal) ok = ok && key <= row;
        if (window > 0) ok = ok && key > row - window;
        if (!ok) sc[i] = -INFINITY;
      }
    }

    // Online softmax in the log2 domain.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < kSc; ++i) {
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    }
    float mu[2], corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r] * scale_log2);
      const bool empty = m_new == -INFINITY;  // every key so far masked
      mu[r] = empty ? 0.f : m_new;
      corr[r] = empty ? 1.f : fast_exp2(m_run[r] - m_new);
      m_run[r] = m_new;
    }
    // P in fp32, split into the A fragments of the next product: in
    // k-slice j, a0 = P(g, key 2t) = sc[4j], a1 = P(g+8, key 2t) =
    // sc[4j+2], a2 = P(g, key 2t+1) = sc[4j+1], a3 = sc[4j+3], which
    // V^T's key order puts at positions t and t+4.
    uint32_t pb[kKp][4], ps[kKp][4];
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kKp; ++j) {
      const float p0 = fast_exp2(fmaf(sc[4 * j], scale_log2, -mu[0]));
      const float p1 = fast_exp2(fmaf(sc[4 * j + 1], scale_log2, -mu[0]));
      const float p2 = fast_exp2(fmaf(sc[4 * j + 2], scale_log2, -mu[1]));
      const float p3 = fast_exp2(fmaf(sc[4 * j + 3], scale_log2, -mu[1]));
      sum[0] += p0 + p1;
      sum[1] += p2 + p3;
      tf32_split(p0, pb[j][0], ps[j][0]);
      tf32_split(p2, pb[j][1], ps[j][1]);
      tf32_split(p1, pb[j][2], ps[j][2]);
      tf32_split(p3, pb[j][3], ps[j][3]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * corr[r] + sum[r];
#pragma unroll
    for (int i = 0; i < kOut; ++i) acc[i] *= corr[(i >> 1) & 1];

    // O += P V: the small cross terms, then big * big.
    const uint32_t vb_s = stage + 2 * L::kKBytes, vs_s = vb_s + L::kVBytes;
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kKp; ++j) {
      const uint32_t off = (j / 4) * L::kVRegion + (j % 4) * 32;
      wgmma_tf32<kNc>(acc, ps[j], gmma_desc(vb_s + off, 16, 1024));
      wgmma_tf32<kNc>(acc, pb[j], gmma_desc(vs_s + off, 16, 1024));
    }
#pragma unroll
    for (int j = 0; j < kKp; ++j) {
      const uint32_t off = (j / 4) * L::kVRegion + (j % 4) * 32;
      wgmma_tf32<kNc>(acc, pb[j], gmma_desc(vb_s + off, 16, 1024));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
  };

  int slot = 0;        // ring slot of tile t
  uint32_t phase = 0;  // parity of the slot's use by tile t
  for (int t = t_lo; t < t_hi; ++t) {
    const uint32_t stage = ring + slot * L::kStageBytes;
    mbar_wait(bar0 + 8 * slot, phase);  // tile t has landed
    // and every warpgroup is done with tile t - 1 (and, at the first
    // tile, with Q in slot 1's space)
    __syncthreads();
    if (tid == 0 && t + 1 < t_hi) copy_kv(t + 1, slot ^ 1);
    if (t >= w_lo && t < w_hi) attend_tile(t, stage);
    slot ^= 1;
    if (slot == 0) phase ^= 1;
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = 1.f / fmaxf(l, 1e-30f);
  }
  float* ob = o + b * so.b + head * so.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= s) continue;
    float* orow = ob + static_cast<int64_t>(row) * so.s + col0;
#pragma unroll
    for (int j = 0; j < 2 * kNc; ++j) {
      *reinterpret_cast<float2*>(orow + 8 * j) = make_float2(
          acc[4 * j + 2 * r] * inv[r], acc[4 * j + 2 * r + 1] * inv[r]);
    }
  }
}

template <int kNc>
int launch_flash_attention_tf32x3(const void* q, const void* k,
                                  const void* v, void* o, void* kx,
                                  void* vtx, Strides sq, Strides sk,
                                  Strides sv, Strides so, int b, int h,
                                  int kvh, int s, int causal, int window,
                                  float scale_log2, cudaStream_t stream) {
  using L = Tf32Layout<kNc>;
  constexpr int hd = L::kHd;
  const int s8 = (s + 7) / 8 * 8;
  float* kxf = static_cast<float*>(kx);
  float* vtf = static_cast<float*>(vtx);
  const int64_t bk = static_cast<int64_t>(b) * kvh;
  const int64_t k_part = bk * s * hd, v_part = bk * hd * s8;
  // K's parts are (B, KvH, S, hd), V^T's (B, KvH, hd, S8), contiguous.
  const int64_t ks = static_cast<int64_t>(s) * hd, vs = int64_t{hd} * s8;
  CUtensorMap tm_q, tm_kb, tm_ks, tm_vb, tm_vs;
  if (!encode_map<float>(&tm_q, q, hd, s, h, b, sq.s, sq.h, sq.b,
                         kTcRows) ||
      !encode_map<float>(&tm_kb, kxf, hd, s, kvh, b, hd, ks, kvh * ks,
                         L::kKeys) ||
      !encode_map<float>(&tm_ks, kxf + k_part, hd, s, kvh, b, hd, ks,
                         kvh * ks, L::kKeys) ||
      !encode_map<float>(&tm_vb, vtf, s8, hd, kvh, b, s8, vs, kvh * vs,
                         hd) ||
      !encode_map<float>(&tm_vs, vtf + v_part, s8, hd, kvh, b, s8, vs,
                         kvh * vs, hd)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 split_grid((s8 + kSplitKeys - 1) / kSplitKeys, b * kvh);
  tf32x3_split_kernel<<<split_grid, kSplitThreads, 0, stream>>>(
      static_cast<const float*>(k), static_cast<const float*>(v), sk, sv,
      kxf, vtf, kvh, s, s8, hd);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int smem = L::kSmemBytes;
  auto kernel = flash_attention_tf32x3_kernel<kNc>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s + kTcRows - 1) / kTcRows, b * h);
  kernel<<<grid, kTcThreads, smem, stream>>>(
      tm_q, tm_kb, tm_ks, tm_vb, tm_vs, static_cast<float*>(o), so, h,
      h / kvh, s, causal, window, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_flash_attention_tf32x3(int nc, const void* q, const void* k,
                                    const void* v, void* o, void* kx,
                                    void* vtx, Strides sq, Strides sk,
                                    Strides sv, Strides so, int b, int h,
                                    int kvh, int s, int causal, int window,
                                    float scale_log2, cudaStream_t stream) {
#define FA_X3_CASE(N)                                                       \
  case N:                                                                   \
    return launch_flash_attention_tf32x3<N>(q, k, v, o, kx, vtx, sq, sk,   \
                                            sv, so, b, h, kvh, s, causal,  \
                                            window, scale_log2, stream);
  switch (nc) {
    FA_X3_CASE(1)
    FA_X3_CASE(2)
    FA_X3_CASE(3)
    FA_X3_CASE(4)
    FA_X3_CASE(5)
    FA_X3_CASE(6)
    FA_X3_CASE(7)
    FA_X3_CASE(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FA_X3_CASE
}

// ---------------------------------------------------------------------
// K5  ssd_scan: h_prev[c] = H_c,  H_0 = 0,  H_{c+1} = H_c * a_c + S_c,
//     with an fp32 carry; h_last = H_C in fp32.
//
// Replaces src/repro/kernels/ssd_scan.py::ssd_scan (Pallas body
// `_kernel`, grid (B*H, C) with the chunk axis sequential and the (P, N)
// carry in VMEM).  Bound at the zamba2-2.7b prefill, states
// (4, 32, 80, 64, 64) bf16: 2*B*C*H*P*N*2 bytes of states in and h_prev
// out, plus 4*B*H*P*N bytes of h_last and the decays, 173 MB, 0.0517 ms
// at 3.35 TB/s: bound by bytes (one multiply and one add per element).
//
// Design against that bound: every access is a 16-byte vector and many
// chunks' loads are in flight behind the dependent carry chain.  The
// main kernel, ssd_scan_vec_kernel, gives each thread 16 bytes of a
// (batch, head)'s P x N plane — 8 bf16 or 4 fp32 elements — and 8
// carries in registers; it walks the chunks in the states' own
// (B, C, H, P, N) layout (a stride of H*P*N between chunks, so no
// transposed copy is made), issuing the loads of 8 chunks before their
// multiply-adds, storing h_prev as 16-byte vectors and h_last as
// float4s.  A block of 128 threads shares one (batch, head); it stages
// that head's decays in shared memory, 64 chunks at a time, so each is
// read once per block.  Loads and stores stream past L1 (__ldcs,
// __stcs): nothing is read twice.  ssd_scan_kernel, one element per
// thread, takes the rest: a plane size that is not a multiple of the
// vector width, or a base that is not 16-byte aligned.  In both, carry
// * a and + s are rounded one at a time (__fmul_rn, __fadd_rn):
// bit-equal to the plain version, which rounds the product first.
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

constexpr int kScanVecThreads = 128;
constexpr int kScanAhead = 8;     // chunks whose loads are issued together
constexpr int kScanDecTile = 64;  // decays staged in shared memory per pass

// 16 bytes of states as fp32 values, and back.
template <typename T>
struct Vec16;
template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void unpack(const uint4& u, float (&f)[kN]) {
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(p[i]);
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  }
  __device__ static uint4 pack(const float (&f)[kN]) {
    uint4 u;
    __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      p[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    }
    return u;
  }
};
template <>
struct Vec16<float> {
  static constexpr int kN = 4;
  __device__ static void unpack(const uint4& u, float (&f)[kN]) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ static uint4 pack(const float (&f)[kN]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

template <typename T>
__global__ void __launch_bounds__(kScanVecThreads)
ssd_scan_vec_kernel(const T* __restrict__ states,
                    const float* __restrict__ decays, T* __restrict__ h_prev,
                    float* __restrict__ h_last, int c, int h, int64_t pn) {
  using V = Vec16<T>;
  __shared__ float dec_s[kScanDecTile];
  const int64_t bh = blockIdx.x;
  const int64_t e =
      (static_cast<int64_t>(blockIdx.y) * kScanVecThreads + threadIdx.x) *
      V::kN;
  const bool live = e < pn;
  const int64_t b = bh / h, head = bh % h;
  const int64_t step = static_cast<int64_t>(h) * pn;  // one chunk
  const int64_t base = (b * c * h + head) * pn + e;
  const float* dec = decays + b * c * h + head;
  float carry[V::kN];
#pragma unroll
  for (int i = 0; i < V::kN; ++i) carry[i] = 0.f;

  for (int j0 = 0; j0 < c; j0 += kScanDecTile) {
    const int nj = min(kScanDecTile, c - j0);
    __syncthreads();  // the previous pass is done with dec_s
    if (static_cast<int>(threadIdx.x) < nj) {
      dec_s[threadIdx.x] = dec[static_cast<int64_t>(j0 + threadIdx.x) * h];
    }
    __syncthreads();
    if (!live) continue;
    for (int jj = 0; jj < nj; jj += kScanAhead) {
      uint4 in[kScanAhead];
#pragma unroll
      for (int u = 0; u < kScanAhead; ++u) {
        if (jj + u < nj) {
          in[u] = __ldcs(reinterpret_cast<const uint4*>(
              states + base + (j0 + jj + u) * step));
        }
      }
#pragma unroll
      for (int u = 0; u < kScanAhead; ++u) {
        if (jj + u < nj) {
          const int64_t off = base + (j0 + jj + u) * step;
          __stcs(reinterpret_cast<uint4*>(h_prev + off), V::pack(carry));
          float sv[V::kN];
          V::unpack(in[u], sv);
          const float a = dec_s[jj + u];
#pragma unroll
          for (int i = 0; i < V::kN; ++i) {
            carry[i] = __fadd_rn(__fmul_rn(carry[i], a), sv[i]);
          }
        }
      }
    }
  }
  if (live) {
    float4* out = reinterpret_cast<float4*>(h_last + bh * pn + e);
#pragma unroll
    for (int i = 0; i < V::kN / 4; ++i) {
      __stcs(out + i, make_float4(carry[4 * i], carry[4 * i + 1],
                                  carry[4 * i + 2], carry[4 * i + 3]));
    }
  }
}

template <typename T>
int launch_ssd_scan(const void* states, const float* decays, void* h_prev,
                    float* h_last, int64_t b, int64_t c, int64_t h,
                    int64_t pn, cudaStream_t stream) {
  constexpr int kV = Vec16<T>::kN;
  const bool vec =
      pn % kV == 0 &&
      ((reinterpret_cast<uintptr_t>(states) |
        reinterpret_cast<uintptr_t>(h_prev) |
        reinterpret_cast<uintptr_t>(h_last)) & 15) == 0;
  const int threads = vec ? kScanVecThreads : kScanThreads;
  const int64_t per_block = vec ? int64_t{kV} * threads : threads;
  const int64_t tiles = (pn + per_block - 1) / per_block;
  if (b * h > 0x7fffffff || tiles > 65535 || c > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(b * h), static_cast<unsigned>(tiles));
  const T* st = static_cast<const T*>(states);
  T* hp = static_cast<T*>(h_prev);
  if (vec) {
    ssd_scan_vec_kernel<T><<<grid, threads, 0, stream>>>(
        st, decays, hp, h_last, static_cast<int>(c), static_cast<int>(h), pn);
  } else {
    ssd_scan_kernel<T><<<grid, threads, 0, stream>>>(
        st, decays, hp, h_last, static_cast<int>(c), static_cast<int>(h), pn);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int mk_flash_attention(const void* q, const void* k, const void* v, void* o,
                       void* kx, void* vtx, int64_t sqb, int64_t sqh,
                       int64_t sqs, int64_t skb, int64_t skh, int64_t sks,
                       int64_t svb, int64_t svh, int64_t svs, int64_t sob,
                       int64_t soh, int64_t sos, int64_t b, int64_t h,
                       int64_t kvh, int64_t s, int64_t hd, int causal,
                       int window, int instance, float scale, void* stream) {
  if (hd % 16 != 0 || hd < 16 || hd > 128 || kvh <= 0 || h % kvh != 0 ||
      b * h > 65535 || s <= 0 || s > (int64_t{1} << 30)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Strides sq{sqb, sqh, sqs}, sk{skb, skh, sks}, sv{svb, svh, svs},
      so{sob, soh, sos};
  const int group = static_cast<int>(h / kvh);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nc = static_cast<int>(hd / 16);
  const float scale_log2 = scale * 1.4426950408889634f;  // hd^-1/2 log2 e
  switch (instance) {
    case 0:  // SIMT, fp32
      return dispatch_flash_attention<float>(
          nc, q, k, v, o, sq, sk, sv, so, static_cast<int>(b),
          static_cast<int>(h), group, static_cast<int>(s), causal, window,
          scale, st);
    case 1:  // tensor cores, bf16
      return dispatch_flash_attention_tc(
          nc, q, k, v, o, sq, sk, sv, so, static_cast<int>(b),
          static_cast<int>(h), static_cast<int>(kvh), static_cast<int>(s),
          causal, window, scale_log2, st);
    case 2:  // tensor cores, fp32 in 3xTF32
      if (kx == nullptr || vtx == nullptr) break;
      return dispatch_flash_attention_tf32x3(
          nc, q, k, v, o, kx, vtx, sq, sk, sv, so, static_cast<int>(b),
          static_cast<int>(h), static_cast<int>(kvh), static_cast<int>(s),
          causal, window, scale_log2, st);
    default:
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

int mk_ssd_scan(const void* states, const float* decays, void* h_prev,
                float* h_last, int64_t b, int64_t c, int64_t h, int64_t pn,
                int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch_ssd_scan<__nv_bfloat16>(states, decays, h_prev, h_last, b,
                                          c, h, pn, st);
  }
  return launch_ssd_scan<float>(states, decays, h_prev, h_last, b, c, h, pn,
                                st);
}


}  // extern "C"
