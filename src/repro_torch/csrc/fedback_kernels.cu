// Hand-written Hopper (sm_90a) kernels of the FedBack round's server passes.
//
// Built by repro_torch/kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes.
// Every entry point launches on the stream it is given, allocates
// nothing, and returns the launch's CUDA error code so the Python
// wrapper can raise on a refused launch.  Tensors are fp32, row-major
// and contiguous (the leaf-table form of K1 also reads bf16 leaves and
// rows at any stride, and K2 and K3 have bf16 instances, K2a and K3a,
// whose operands are all bf16); the wrappers check that before passing
// pointers,
// and compute each launch's geometry (K1's segments and leaf table, K3's
// grid and tiles) in Python, where the CPU tests check it.
//
// All the kernels move bytes and do almost no arithmetic, so on an
// H100 (3.35 TB/s HBM3, 67 TFLOP/s fp32) each is bound by memory
// traffic; the byte counts below are what one call must move.  At the
// paper-MNIST width (D = 159,010) a row is 636,040 bytes, 8 mod 16, so
// odd rows start 8 bytes off a 16-byte boundary: no TMA tensor map
// (global strides must be multiples of 16) or bulk copy can describe
// the (N, D) arrays, and the kernels move them with vector loads, with
// enough of them in flight to cover the memory's latency.
//
// No kernel is compiled with fast math, and the elementwise ones
// contain no multiply, so nvcc has nothing to contract into an FMA:
// their outputs are bit-identical to the plain PyTorch versions.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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
// sequential grid over D).  Bound: N*D*4 + D*4 bytes (64.2 MB at the
// paper-MNIST width N=100, D=159,010, about 19 us at 3.35 TB/s).
//
// Design: each row is split into S segments (S <= 8, chosen from D
// alone by the wrapper: 8 at the paper width, so 800 blocks fill the
// 132 SMs in one wave), and the S blocks of a row form one thread-block
// cluster.  Segment boundaries fall at row-relative multiples of 4
// elements: segment r covers the groups of 4 [r*G, min((r+1)*G, D/4)),
// and the last one also the D mod 4 tail elements.  Thread t of a
// segment reads the groups g0 + t, g0 + t + 256, ..., 4 groups per
// step, all loads issued before their multiply-adds, into 4
// accumulators (one per slot of the step); w is read through the
// read-only cache (shared by every row: one HBM read, the rest hit L2).
// z takes plain loads: evict-first (streaming) loads made the pass a
// third slower at 8 segments on an H100 80GB HBM3 (PERF.md).  A group of z is
// one 16-byte float4 load where the row start is 16-byte aligned, else
// two 8-byte float2 loads (at D = 159,010 odd rows start 8 bytes off),
// else four scalar loads; w is read as float4 where its base is 16-byte
// aligned (the wrapper checks it and picks the instance), else as
// scalars.  The arithmetic is the same in every path: one fmaf per
// element into the step slot's accumulator, the 4 accumulators added as
// (a0+a1)+(a2+a3), then the tail, then a block reduction (warp
// shuffles, then one warp over the 8 warp sums), each in a fixed
// order.  Each block leaves its segment's sum in its own shared memory;
// after a cluster barrier the cluster's rank-0 block reads the S sums
// through distributed shared memory in rank order, adds them in that
// order and writes out[row]; a second barrier keeps the peers resident
// until it has read.  So a row's result depends only on its values and D
// -- not on its address, its alignment, N, or the order in which blocks
// run -- and identical rows give bit-equal distances, as the compact
// plan's ties need.  The sum differs from the plain version's only by
// its order and the FMA's single rounding.
//
// What bounds it: HBM bandwidth over the z stream.  Every SM holds about
// six blocks of 256 threads, each thread with 64 bytes of z (and 64 of
// w) in flight, above the ~20 KB per SM that Little's law asks for at
// 3.35 TB/s.  A variant that never read w was no faster, so the L2
// traffic of w does not bound it.
constexpr int kTrigSteps = 4;  // groups of 4 per thread in flight

template <int kVec>
__device__ __forceinline__ float4 load_z_group(const float* zr, int64_t g) {
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
__device__ __forceinline__ float4 load_w_group(const float* w, int64_t g) {
  if (kVec == 4) return __ldg(reinterpret_cast<const float4*>(w) + g);
  const float* p = w + 4 * g;
  return make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
}

__device__ __forceinline__ float add_squares(float acc, float4 a, float4 b) {
  float t = a.x - b.x;
  acc = fmaf(t, t, acc);
  t = a.y - b.y;
  acc = fmaf(t, t, acc);
  t = a.z - b.z;
  acc = fmaf(t, t, acc);
  t = a.w - b.w;
  return fmaf(t, t, acc);
}

// One row of K1's (n, d) matrix as the source of segment_partial's
// groups: z at the row's own alignment (kVecZ), w at its (kVecW).
template <int kVecZ, int kVecW>
struct MatrixRow {
  const float* __restrict__ zr;
  const float* __restrict__ w;
  __device__ __forceinline__ void group(int64_t g, float4& a, float4& b) {
    a = load_z_group<kVecZ>(zr, g);
    b = load_w_group<kVecW>(w, g);
  }
  __device__ __forceinline__ void element(int64_t j, float& a, float& b) {
    a = zr[j];
    b = __ldg(w + j);
  }
};

// This thread's part of the groups [g0, g1) of one row, read through
// `src` (K1's MatrixRow, or the leaf table's TableRow below): the order
// of the sum is the same whatever the source.  A slot past g1 adds
// (0 - 0)^2 = +0 to a non-negative sum, which leaves it unchanged.
template <class Row>
__device__ __forceinline__ float segment_partial(Row& src, int64_t g0,
                                                 int64_t g1) {
  float acc[kTrigSteps];
#pragma unroll
  for (int u = 0; u < kTrigSteps; ++u) acc[u] = 0.f;
  for (int64_t g = g0 + threadIdx.x; g < g1; g += kTrigSteps * kThreads) {
    float4 a[kTrigSteps], b[kTrigSteps];
#pragma unroll
    for (int u = 0; u < kTrigSteps; ++u) {
      const int64_t gg = g + u * kThreads;
      if (gg < g1) {
        src.group(gg, a[u], b[u]);
      } else {
        a[u] = b[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
#pragma unroll
    for (int u = 0; u < kTrigSteps; ++u) {
      acc[u] = add_squares(acc[u], a[u], b[u]);
    }
  }
  return (acc[0] + acc[1]) + (acc[2] + acc[3]);
}

// The d mod 4 tail elements of a row, added to the last segment's sum.
template <class Row>
__device__ __forceinline__ float tail_partial(Row& src, int64_t d,
                                              float acc) {
  for (int64_t j = 4 * (d / 4) + threadIdx.x; j < d; j += kThreads) {
    float a, b;
    src.element(j, a, b);
    const float t = a - b;
    acc = fmaf(t, t, acc);
  }
  return acc;
}

// The block's sum of its threads' `acc`, then the cluster's sum of its
// blocks' in rank order, written by rank 0 to *out.
__device__ __forceinline__ void cluster_row_sum(float acc, float* out) {
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const unsigned nseg = cluster.num_blocks();
  __shared__ float partial[kWarps];
  __shared__ float seg_sum;
  acc = warp_sum(acc);
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x < 32) {
    float v = threadIdx.x < kWarps ? partial[threadIdx.x] : 0.f;
    v = warp_sum(v);
    if (threadIdx.x == 0) seg_sum = v;
  }
  cluster.sync();  // every segment's sum is in its block's shared memory
  if (rank == 0 && threadIdx.x == 0) {
    float v = 0.f;
    for (unsigned r = 0; r < nseg; ++r) {
      v += *cluster.map_shared_rank(&seg_sum, r);
    }
    *out = v;
  }
  cluster.sync();  // peers stay resident until rank 0 has read them
}

// Grid: N * S blocks in clusters of S (cluster r of the grid is row r).
template <int kVecW>
__global__ void __launch_bounds__(kThreads)
trigger_sq_norms_kernel(const float* __restrict__ z,
                        const float* __restrict__ w,
                        float* __restrict__ out, int64_t d,
                        int64_t seg_groups) {
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const unsigned nseg = cluster.num_blocks();
  const int64_t row = blockIdx.x / nseg;
  const float* zr = z + row * d;
  const int64_t ngroups = d / 4;
  const int64_t g0 = min(static_cast<int64_t>(rank) * seg_groups, ngroups);
  const int64_t g1 = min(g0 + seg_groups, ngroups);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(zr);
  float acc;
  if ((addr & 15u) == 0) {
    MatrixRow<4, kVecW> src{zr, w};
    acc = segment_partial(src, g0, g1);
  } else if ((addr & 7u) == 0) {
    MatrixRow<2, kVecW> src{zr, w};
    acc = segment_partial(src, g0, g1);
  } else {
    MatrixRow<1, kVecW> src{zr, w};
    acc = segment_partial(src, g0, g1);
  }
  if (rank == nseg - 1) {
    MatrixRow<1, kVecW> src{zr, w};
    acc = tail_partial(src, d, acc);
  }
  cluster_row_sum(acc, out + row);
}

// ---------------------------------------------------------------------
// K1 on a leaf table: K1c (a stacked client tree, read leaf by leaf in
// place), K1b (every shard of a client mesh that lies on one card, in
// one launch) and K1a (a bf16 z or w).
//
// Replaces src/repro/kernels/ops.py::trigger_sq_norms_pytree (the
// reference casts each leaf to fp32 and concatenates the leaves into
// the (N, D) operand of K1 in XLA, outside its Pallas body) and
// src/repro/kernels/trigger_norms.py::trigger_sq_norms_sharded (K1 under
// shard_map, one launch per device on its rows).  Bound: every z and w
// leaf read once at its own dtype, and the (N,) sums written: 79.4 MB
// for the CIFAR CNN's 12 leaves at N = 100 (about 23.7 us at 3.35 TB/s);
// the concatenation made the bytes cross HBM three times.
//
// Design: the launch's table lists the card's shards as row blocks (a
// prefix of row counts; the output holds the rows in table order) and,
// for each shard, the tree's leaves in sorted-key order: the z and w
// leaf pointers, z's row stride, the leaf's columns [begin, end) in the
// virtual row that the concatenation would build, and each one's dtype
// (fp32 or bf16).  It travels by value in the kernel's parameters (a
// __grid_constant__ struct, up to CUDA 12.1's 32,764 bytes on sm_70 and
// above), so a launch needs no host-to-device copy and no host sync and
// can be captured in a CUDA graph.  The grid, the segments (S, G) of
// the virtual row and the mapping of threads to groups of 4 and to the
// 4 accumulators are K1's, through the same segment_partial, tail_partial
// and cluster_row_sum: only the load of a group differs.  A group
// inside one leaf is one vector load per operand where its address
// allows (fp32: 16 bytes, else two of 8; bf16: 8 bytes, else two of 4),
// else four scalar loads; a group that straddles leaves takes each
// element from its own leaf.  bf16 widens to fp32 exactly, so every
// row's sum is bit-equal to K1's on the fp32 concatenation.  Each
// thread keeps a cursor on the leaf of its current column: its columns
// only grow (slot by slot, step by step, then the tail), so the cursor
// only moves forward and reads the table when it enters a leaf, never
// per byte.
//
// What bounds it: HBM bandwidth, as K1, less the residency the table
// costs.  ptxas gives the kernel 58 registers a thread against K1's 32,
// so an SM holds 4 of its blocks where it holds 8 of K1's: of the
// N = 100 rows' 8-block clusters about 64 fit on the 132 SMs at a time
// (a cluster stays within one of the 8 GPCs), where K1's all fit, and
// the rest run as a second, partial wave (PERF.md §6).  Capping the
// registers with __launch_bounds__ (5, 6 or 8 blocks an SM) made ptxas
// spill the in-flight groups and ran slower on an H100, so the kernel
// is left uncapped.
struct TableLeaf {
  const void* z;       // the leaf's row 0 of this shard
  const void* w;       // the w leaf
  int64_t z_row;       // elements between two rows of z
  int64_t begin, end;  // its columns in the virtual row
  int32_t z_bf16, w_bf16;
};

template <int kShards, int kEntries>
struct TriggerTable {
  float* out;
  int64_t d, seg_groups;
  int32_t n_shards, n_leaves;
  int64_t row_start[kShards + 1];  // shard s owns rows [row_start[s], [s+1])
  TableLeaf leaf[kEntries];        // shard s's leaf l at s * n_leaves + l
};

// The parameter space of one launch (CUDA 12.1+, sm_70+).
constexpr size_t kMaxParamBytes = 32764;
static_assert(sizeof(TableLeaf) == 48, "the wrapper packs 6 words a leaf");

__device__ __forceinline__ float bf16_bits(uint32_t bits) {
  return __bfloat162float(__ushort_as_bfloat16(
      static_cast<unsigned short>(bits & 0xffffu)));
}

// Two words of two bf16 each (the lower address in the low half).
__device__ __forceinline__ float4 bf16x4(uint32_t lo, uint32_t hi) {
  return make_float4(bf16_bits(lo), bf16_bits(lo >> 16), bf16_bits(hi),
                     bf16_bits(hi >> 16));
}

// 4 consecutive elements at p, widened to fp32.  kReadOnly loads go
// through the read-only cache (w, shared by every row).
template <bool kReadOnly>
__device__ __forceinline__ float4 load_quad(uintptr_t p, bool bf16) {
  if (bf16) {
    if ((p & 7u) == 0) {
      const uint2* q = reinterpret_cast<const uint2*>(p);
      const uint2 v = kReadOnly ? __ldg(q) : *q;
      return bf16x4(v.x, v.y);
    }
    if ((p & 3u) == 0) {
      const unsigned* q = reinterpret_cast<const unsigned*>(p);
      return kReadOnly ? bf16x4(__ldg(q), __ldg(q + 1)) : bf16x4(q[0], q[1]);
    }
    const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
    uint32_t e[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) e[k] = kReadOnly ? __ldg(q + k) : q[k];
    return make_float4(bf16_bits(e[0]), bf16_bits(e[1]), bf16_bits(e[2]),
                       bf16_bits(e[3]));
  }
  if ((p & 15u) == 0) {
    const float4* q = reinterpret_cast<const float4*>(p);
    return kReadOnly ? __ldg(q) : *q;
  }
  if ((p & 7u) == 0) {
    const float2* q = reinterpret_cast<const float2*>(p);
    const float2 lo = kReadOnly ? __ldg(q) : q[0];
    const float2 hi = kReadOnly ? __ldg(q + 1) : q[1];
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  }
  const float* q = reinterpret_cast<const float*>(p);
  return kReadOnly ? make_float4(__ldg(q), __ldg(q + 1), __ldg(q + 2),
                                 __ldg(q + 3))
                   : make_float4(q[0], q[1], q[2], q[3]);
}

template <bool kReadOnly>
__device__ __forceinline__ float load_elem(uintptr_t p, bool bf16) {
  if (bf16) {
    const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
    return bf16_bits(kReadOnly ? __ldg(q) : *q);
  }
  const float* q = reinterpret_cast<const float*>(p);
  return kReadOnly ? __ldg(q) : *q;
}

// One row of one shard, read through the leaf table: column c of leaf l
// lies at zb + c * (its element size) for z and wb + ... for w, the
// bases shifted back by the leaf's first column when the cursor enters
// it.
struct TableRow {
  const TableLeaf* leaves;  // this shard's, in the kernel's parameters
  int64_t row;              // within the shard
  int l;
  int64_t end;
  uintptr_t zb, wb;
  bool zbf, wbf;

  __device__ __forceinline__ TableRow(const TableLeaf* lv, int64_t r)
      : leaves(lv), row(r), l(0) {
    enter();
  }
  __device__ __forceinline__ void enter() {
    const TableLeaf& e = leaves[l];
    zbf = e.z_bf16 != 0;
    wbf = e.w_bf16 != 0;
    zb = reinterpret_cast<uintptr_t>(e.z) +
         (row * e.z_row - e.begin) * (zbf ? 2 : 4);
    wb = reinterpret_cast<uintptr_t>(e.w) - e.begin * (wbf ? 2 : 4);
    end = e.end;
  }
  // Move the cursor to the leaf that holds column c (c < d; leaves of
  // width 0 are passed over).
  __device__ __forceinline__ void seek(int64_t c) {
    while (c >= end) {
      ++l;
      enter();
    }
  }
  __device__ __forceinline__ void element(int64_t j, float& a, float& b) {
    seek(j);
    a = load_elem<false>(zb + j * (zbf ? 2 : 4), zbf);
    b = load_elem<true>(wb + j * (wbf ? 2 : 4), wbf);
  }
  __device__ __forceinline__ void group(int64_t g, float4& a, float4& b) {
    const int64_t c = 4 * g;
    seek(c);
    if (c + 4 <= end) {
      a = load_quad<false>(zb + c * (zbf ? 2 : 4), zbf);
      b = load_quad<true>(wb + c * (wbf ? 2 : 4), wbf);
      return;
    }
    element(c, a.x, b.x);
    element(c + 1, a.y, b.y);
    element(c + 2, a.z, b.z);
    element(c + 3, a.w, b.w);
  }
};

// Grid: (rows of the table) * S blocks in clusters of S, K1's geometry
// over the virtual row of d columns.
template <int kShards, int kEntries>
__global__ void __launch_bounds__(kThreads)
trigger_table_kernel(const __grid_constant__ TriggerTable<kShards, kEntries>
                         t) {
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const unsigned nseg = cluster.num_blocks();
  const int64_t row = blockIdx.x / nseg;
  int s = 0;
  while (row >= t.row_start[s + 1]) ++s;
  TableRow src(t.leaf + s * t.n_leaves, row - t.row_start[s]);
  const int64_t ngroups = t.d / 4;
  const int64_t g0 = min(static_cast<int64_t>(rank) * t.seg_groups, ngroups);
  const int64_t g1 = min(g0 + t.seg_groups, ngroups);
  float acc = segment_partial(src, g0, g1);
  if (rank == nseg - 1) acc = tail_partial(src, t.d, acc);
  cluster_row_sum(acc, t.out + row);
}

template <int kShards, int kEntries>
cudaError_t launch_table(const int64_t* rows, int n_shards,
                         const int64_t* leaves, int n_leaves, int64_t d,
                         int segs, int64_t seg_groups, float* out,
                         cudaStream_t stream) {
  static_assert(sizeof(TriggerTable<kShards, kEntries>) <= kMaxParamBytes,
                "the table must fit the kernel's parameters");
  TriggerTable<kShards, kEntries> t = {};
  t.out = out;
  t.d = d;
  t.seg_groups = seg_groups;
  t.n_shards = n_shards;
  t.n_leaves = n_leaves;
  for (int s = 0; s <= n_shards; ++s) t.row_start[s] = rows[s];
  for (int i = 0; i < n_shards * n_leaves; ++i) {
    const int64_t* e = leaves + 6 * i;
    TableLeaf& x = t.leaf[i];
    x.z = reinterpret_cast<const void*>(static_cast<uintptr_t>(e[0]));
    x.w = reinterpret_cast<const void*>(static_cast<uintptr_t>(e[1]));
    x.z_row = e[2];
    x.begin = e[3];
    x.end = e[4];
    x.z_bf16 = static_cast<int32_t>(e[5] & 1);
    x.w_bf16 = static_cast<int32_t>((e[5] >> 1) & 1);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(rows[n_shards] * segs));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(segs);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, trigger_table_kernel<kShards, kEntries>, t);
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
// modulo cheap.  The kernel is templated on the element type E (F32,
// BF16 below).
//
// K2a, the bf16 instance: where every base is 16-byte aligned (the
// wrapper decides) admm_update_bf16x8_kernel takes 8 consecutive
// elements of the flat (N, D) arrays as one 16-byte load or store per
// stream, the last total % 8 elements one by one; w is read element by
// element at (i + k) % D, a 2-byte read through the read-only cache (at
// D = 159,010 a row is 4 mod 16 bytes, so a group of 8 may straddle two
// rows).  Elsewhere admm_update_kernel<BF16> takes one element at a
// time.  Bound: the same streams at 2 bytes an element, 127 MB for the
// dense form at N=100, D=159,010 (about 38 us).
//
// bf16 arithmetic as the reference's bf16 arrays do it: each add or
// subtract is taken in fp32 on the widened operands and rounded to bf16
// (round to nearest even) before the next uses it.  A sum or difference
// of two bf16 values taken in fp32 and rounded to bf16 is the correctly
// rounded bf16 result (24 >= 2*8 + 2 bits), so
//   lam+ = rn(rn(lam + theta) - w) ; z = rn(theta + lam+) ;
//   c = rn(w - lam+)
// is bit-equal to the plain version's bf16 ops.  __fadd_rn/__fsub_rn
// keep nvcc from contracting anything (there is no multiply to fuse
// with, but the intent is stated).
__device__ __forceinline__ unsigned short bf16_rn(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float bf16_round(float x) {
  return bf16_bits(bf16_rn(x));
}

// The element types of K2 and K3.  Both compute in fp32; F32 stores what
// it computes, BF16 (bf16 kept as its 16 bits) rounds to bf16 after
// every add or subtract (`rnd`).  A pair (K3's kVec 2) is a float2 or one
// 32-bit word of two bf16.
struct F32 {
  using T = float;
  using T2 = float2;
  static __device__ __forceinline__ float get(float x) { return x; }
  static __device__ __forceinline__ float put(float x) { return x; }
  static __device__ __forceinline__ float rnd(float x) { return x; }
  static __device__ __forceinline__ void get2(float2 v, float& a,
                                              float& b) {
    a = v.x;
    b = v.y;
  }
  static __device__ __forceinline__ float2 put2(float a, float b) {
    return make_float2(a, b);
  }
};

struct BF16 {
  using T = unsigned short;
  using T2 = unsigned int;
  static __device__ __forceinline__ float get(unsigned short x) {
    return bf16_bits(x);
  }
  static __device__ __forceinline__ unsigned short put(float x) {
    return bf16_rn(x);
  }
  static __device__ __forceinline__ float rnd(float x) {
    return bf16_round(x);
  }
  static __device__ __forceinline__ void get2(unsigned int v, float& a,
                                              float& b) {
    a = bf16_bits(v);
    b = bf16_bits(v >> 16);
  }
  static __device__ __forceinline__ unsigned int put2(float a, float b) {
    return static_cast<unsigned int>(bf16_rn(a)) |
           (static_cast<unsigned int>(bf16_rn(b)) << 16);
  }
};

// lam+ = rnd(rnd(lam + theta) - w), exactly E's value (K2 and K3).
template <typename E>
__device__ __forceinline__ float lam_plus(float l, float t, float wj) {
  return E::rnd(__fsub_rn(E::rnd(__fadd_rn(l, t)), wj));
}

// One element of K2: lam+ stored, z = theta + lam+ and c = w - lam+
// rounded by their stores.
template <typename E, bool kWithZ, typename Index>
__device__ __forceinline__ void admm_element(
    const typename E::T* __restrict__ th, const typename E::T* __restrict__ la,
    const typename E::T* __restrict__ w, typename E::T* __restrict__ lam_out,
    typename E::T* __restrict__ z_out, typename E::T* __restrict__ c_out,
    Index i, Index d) {
  const float t = E::get(th[i]);
  const float wj = E::get(__ldg(w + i % d));
  const float lam_new = lam_plus<E>(E::get(la[i]), t, wj);
  lam_out[i] = E::put(lam_new);
  if (kWithZ) z_out[i] = E::put(__fadd_rn(t, lam_new));
  c_out[i] = E::put(__fsub_rn(wj, lam_new));
}

template <typename E, bool kWithZ, typename Index>
__global__ void __launch_bounds__(kThreads)
admm_update_kernel(const typename E::T* __restrict__ th,
                   const typename E::T* __restrict__ la,
                   const typename E::T* __restrict__ w,
                   typename E::T* __restrict__ lam_out,
                   typename E::T* __restrict__ z_out,
                   typename E::T* __restrict__ c_out, Index total, Index d) {
  const Index stride = static_cast<Index>(gridDim.x) * kThreads;
  for (Index i = static_cast<Index>(blockIdx.x) * kThreads + threadIdx.x;
       i < total; i += stride) {
    admm_element<E, kWithZ>(th, la, w, lam_out, z_out, c_out, i, d);
  }
}

// Eight bf16 in one 16-byte word, the lower address in the low half.
__device__ __forceinline__ void unpack8(uint4 v, float (&x)[8]) {
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    x[2 * j] = bf16_bits(u[j]);
    x[2 * j + 1] = bf16_bits(u[j] >> 16);
  }
}

__device__ __forceinline__ uint4 pack8(const float (&x)[8]) {
  uint32_t u[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    u[j] = static_cast<uint32_t>(bf16_rn(x[2 * j])) |
           (static_cast<uint32_t>(bf16_rn(x[2 * j + 1])) << 16);
  }
  return make_uint4(u[0], u[1], u[2], u[3]);
}

// K2a's 16-byte form: groups of 8 elements as uint4 (every base 16-byte
// aligned), the last total % 8 elements as admm_element<BF16>.
template <bool kWithZ>
__global__ void __launch_bounds__(kThreads)
admm_update_bf16x8_kernel(const unsigned short* __restrict__ th,
                          const unsigned short* __restrict__ la,
                          const unsigned short* __restrict__ w,
                          unsigned short* __restrict__ lam_out,
                          unsigned short* __restrict__ z_out,
                          unsigned short* __restrict__ c_out, int64_t total,
                          int64_t d) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads +
                      threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t groups = total / 8;
  for (int64_t g = tid; g < groups; g += stride) {
    const int64_t i0 = g * 8;
    float t[8], l[8], lo[8], zo[8], co[8];
    unpack8(*reinterpret_cast<const uint4*>(th + i0), t);
    unpack8(*reinterpret_cast<const uint4*>(la + i0), l);
    int64_t col = i0 % d;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float wj = bf16_bits(__ldg(w + col));
      lo[k] = lam_plus<BF16>(l[k], t[k], wj);
      zo[k] = __fadd_rn(t[k], lo[k]);  // z and c rounded by pack8
      co[k] = __fsub_rn(wj, lo[k]);
      if (++col == d) col = 0;
    }
    *reinterpret_cast<uint4*>(lam_out + i0) = pack8(lo);
    if (kWithZ) *reinterpret_cast<uint4*>(z_out + i0) = pack8(zo);
    *reinterpret_cast<uint4*>(c_out + i0) = pack8(co);
  }
  const int64_t i = groups * 8 + tid;  // the tail, fewer than 8
  if (i < total) {
    admm_element<BF16, kWithZ>(th, la, w, lam_out, z_out, c_out, i, d);
  }
}

// K2's four instances of element type E: with or without z, a 32-bit
// index where N*D fits.
template <typename E>
int launch_admm_update(const typename E::T* th, const typename E::T* la,
                       const typename E::T* w, typename E::T* lam_out,
                       typename E::T* z_out, typename E::T* c_out,
                       int64_t total, int64_t d, int grid, int with_z,
                       cudaStream_t s) {
  if (total < (int64_t{1} << 31)) {
    const uint32_t t32 = static_cast<uint32_t>(total);
    const uint32_t d32 = static_cast<uint32_t>(d);
    if (with_z) {
      admm_update_kernel<E, true, uint32_t><<<grid, kThreads, 0, s>>>(
          th, la, w, lam_out, z_out, c_out, t32, d32);
    } else {
      admm_update_kernel<E, false, uint32_t><<<grid, kThreads, 0, s>>>(
          th, la, w, lam_out, z_out, c_out, t32, d32);
    }
  } else if (with_z) {
    admm_update_kernel<E, true, int64_t><<<grid, kThreads, 0, s>>>(
        th, la, w, lam_out, z_out, c_out, total, d);
  } else {
    admm_update_kernel<E, false, int64_t><<<grid, kThreads, 0, s>>>(
        th, la, w, lam_out, z_out, c_out, total, d);
  }
  return static_cast<int>(cudaGetLastError());
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
// solved row, writes theta/lam (+z) rows: 6*V*D*4 bytes with z (5
// without) plus w, 54.1 MB at V = 14 valid of C = 16, D = 159,010
// (about 16.1 us at 3.35 TB/s).  An invalid slot neither reads nor
// writes anything and z_prev is never read, so this is 6 streams; the
// Pallas kernel's count is 7 (it reads z_prev for its masked
// write-back), which is not this kernel's.
//
// Design: a grid sized to the card by the wrapper (16 blocks of 256
// threads per SM, two waves of the 8 an SM holds) strides over tiles t
// = slot * T + chunk, T = ceil(D / 1024): block b takes tiles b, b + G,
// b + 2G, ..., two per step, and issues the loads of both tiles (theta,
// lam, solved, w) before their stores.  At the paper width a block has 1
// or 2 tiles: with 4 blocks per SM, each striding over ~5 tiles, the
// blocks left with a third step made a tail that cost 9% on an H100
// 80GB HBM3 (PERF.md); for larger C * D the blocks stride further.  A
// tile reads valid[slot] and idx[slot] (one byte and one int) and is
// skipped when the slot is invalid or its row lies outside [0, N);
// blocks are not tied to slots, so an invalid slot adds no blocks that
// launch only to exit, and the plan needs no host-side compaction.  A
// tile covers 1024 columns, 4 per thread: as two float2 per stream
// where D is even and every base is 8-byte aligned (so every row is),
// else as four scalars; the wrapper picks the instance per launch and
// the arithmetic is the same.  solved (read once) and z (written once)
// take streaming hints (plain accesses timed the same on the
// H100).  Plan indices are distinct, so no two threads write one
// element.
//
// K3a, the bf16 instance (E = BF16): the same tiles and grid over bf16
// arrays, a pair of columns a 4-byte word where D is even and every
// base is 4-byte aligned (at D = 159,010 a bf16 row is 4 mod 16 bytes,
// so no wider access fits every row), each add or subtract rounded to
// bf16 as in K2a.  Bound: 6*V*D*2 + 2*D bytes, 27.0 MB at the width
// above (about 8.1 us).
constexpr int kGssColsPerThread = 4;
constexpr int kGssTileCols = kGssColsPerThread * kThreads;  // 1024
constexpr int kGssTilesPerStep = 2;

enum Access { kPlain, kStream, kReadOnly };

template <Access kAcc, typename X>
__device__ __forceinline__ X ld(const X* p) {
  if (kAcc == kStream) return __ldcs(p);
  if (kAcc == kReadOnly) return __ldg(p);
  return *p;
}

template <bool kStreaming, typename X>
__device__ __forceinline__ void st(X* p, X x) {
  if (kStreaming) {
    __stcs(p, x);
  } else {
    *p = x;
  }
}

// Column of this thread's k-th element (k < 4) in the tile at column
// j0: pairs 2*(u*256 + t) for u = 0, 1, or single elements u*256 + t.
template <int kVec>
__device__ __forceinline__ int64_t gss_col(int64_t j0, int k) {
  return kVec == 2 ? j0 + 2 * ((k >> 1) * kThreads + threadIdx.x) + (k & 1)
                   : j0 + k * kThreads + threadIdx.x;
}

template <typename E, int kVec, Access kAcc>
__device__ __forceinline__ void load_tile(const typename E::T* row,
                                          int64_t j0, int64_t d, bool on,
                                          float (&v)[kGssColsPerThread]) {
#pragma unroll
  for (int k = 0; k < kGssColsPerThread; k += kVec) {
    const int64_t j = gss_col<kVec>(j0, k);
    if (on && j < d) {
      if (kVec == 2) {
        E::get2(ld<kAcc>(reinterpret_cast<const typename E::T2*>(row + j)),
                v[k], v[k + 1]);
      } else {
        v[k] = E::get(ld<kAcc>(row + j));
      }
    } else {
      v[k] = 0.f;
      if (kVec == 2) v[k + 1] = 0.f;
    }
  }
}

template <typename E, int kVec, bool kStreaming>
__device__ __forceinline__ void store_tile(
    typename E::T* row, int64_t j0, int64_t d, bool on,
    const float (&v)[kGssColsPerThread]) {
#pragma unroll
  for (int k = 0; k < kGssColsPerThread; k += kVec) {
    const int64_t j = gss_col<kVec>(j0, k);
    if (on && j < d) {
      if (kVec == 2) {
        st<kStreaming>(reinterpret_cast<typename E::T2*>(row + j),
                       E::put2(v[k], v[k + 1]));
      } else {
        st<kStreaming>(row + j, E::put(v[k]));
      }
    }
  }
}

template <typename E, bool kWithZ, int kVec>
__global__ void __launch_bounds__(kThreads)
fused_gss_kernel(const int32_t* __restrict__ idx,
                 const bool* __restrict__ valid,
                 const typename E::T* __restrict__ solved,
                 const typename E::T* __restrict__ w,
                 typename E::T* __restrict__ th,
                 typename E::T* __restrict__ la,
                 typename E::T* __restrict__ z, int64_t c, int64_t n,
                 int64_t d, int64_t tiles_per_slot) {
  constexpr int S = kGssTilesPerStep;
  const int64_t tiles = c * tiles_per_slot;
  const int64_t grid = gridDim.x;
  for (int64_t t0 = blockIdx.x; t0 < tiles; t0 += S * grid) {
    bool on[S];
    int64_t slot[S], row[S], j0[S];
    float thv[S][kGssColsPerThread], lav[S][kGssColsPerThread];
    float sv[S][kGssColsPerThread], wv[S][kGssColsPerThread];
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const int64_t t = t0 + i * grid;
      on[i] = false;
      slot[i] = row[i] = j0[i] = 0;
      if (t < tiles) {
        slot[i] = t / tiles_per_slot;
        j0[i] = (t - slot[i] * tiles_per_slot) * kGssTileCols;
        if (valid[slot[i]]) {
          row[i] = idx[slot[i]];
          on[i] = row[i] >= 0 && row[i] < n;
        }
      }
      if (!on[i]) row[i] = 0;
      load_tile<E, kVec, kPlain>(th + row[i] * d, j0[i], d, on[i], thv[i]);
      load_tile<E, kVec, kPlain>(la + row[i] * d, j0[i], d, on[i], lav[i]);
      load_tile<E, kVec, kStream>(solved + slot[i] * d, j0[i], d, on[i],
                                  sv[i]);
      load_tile<E, kVec, kReadOnly>(w, j0[i], d, on[i], wv[i]);
    }
#pragma unroll
    for (int i = 0; i < S; ++i) {
      float zv[kGssColsPerThread];
#pragma unroll
      for (int k = 0; k < kGssColsPerThread; ++k) {
        const float lam_new = lam_plus<E>(lav[i][k], thv[i][k], wv[i][k]);
        lav[i][k] = lam_new;
        zv[k] = __fadd_rn(sv[i][k], lam_new);  // rounded by the store
      }
      store_tile<E, kVec, false>(th + row[i] * d, j0[i], d, on[i], sv[i]);
      store_tile<E, kVec, false>(la + row[i] * d, j0[i], d, on[i], lav[i]);
      if (kWithZ) {
        store_tile<E, kVec, true>(z + row[i] * d, j0[i], d, on[i], zv);
      }
    }
  }
}

// K3's four instances of element type E: with or without z, pairs or
// single elements.
template <typename E>
int launch_fused_gss(const int32_t* idx, const bool* valid,
                     const typename E::T* solved, const typename E::T* w,
                     typename E::T* th, typename E::T* la, typename E::T* z,
                     int64_t c, int64_t n, int64_t d, int grid,
                     int64_t tiles_per_slot, int vec, int with_z,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned g = static_cast<unsigned>(grid);
  if (with_z && vec == 2) {
    fused_gss_kernel<E, true, 2><<<g, kThreads, 0, s>>>(
        idx, valid, solved, w, th, la, z, c, n, d, tiles_per_slot);
  } else if (with_z) {
    fused_gss_kernel<E, true, 1><<<g, kThreads, 0, s>>>(
        idx, valid, solved, w, th, la, z, c, n, d, tiles_per_slot);
  } else if (vec == 2) {
    fused_gss_kernel<E, false, 2><<<g, kThreads, 0, s>>>(
        idx, valid, solved, w, th, la, z, c, n, d, tiles_per_slot);
  } else {
    fused_gss_kernel<E, false, 1><<<g, kThreads, 0, s>>>(
        idx, valid, solved, w, th, la, z, c, n, d, tiles_per_slot);
  }
  return static_cast<int>(cudaGetLastError());
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

// z: (n, d); one cluster of `segs` blocks per row, each summing
// `seg_groups` groups of 4; w_vec 4 where w is 16-byte aligned, else 1.
int fb_trigger_sq_norms(const float* z, const float* w, float* out,
                        int64_t n, int64_t d, int segs, int64_t seg_groups,
                        int w_vec, void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(n * segs));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(segs);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      w_vec == 4 ? cudaLaunchKernelEx(&cfg, trigger_sq_norms_kernel<4>, z, w,
                                      out, d, seg_groups)
                 : cudaLaunchKernelEx(&cfg, trigger_sq_norms_kernel<1>, z, w,
                                      out, d, seg_groups);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The leaf table of one launch: `rows` the n_shards + 1 row offsets,
// `leaves` n_shards * n_leaves entries of 6 int64 words (z, w, z's row
// stride, begin, end, dtype bits: 1 z bf16, 2 w bf16), shard-major; the
// smallest table instance that holds them is launched.  Returns
// cudaErrorInvalidValue for a table larger than the largest instance
// (the wrapper refuses it first).
int fb_trigger_sq_norms_table(const int64_t* rows, int n_shards,
                              const int64_t* leaves, int n_leaves,
                              int64_t d, int segs, int64_t seg_groups,
                              float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int entries = n_shards * n_leaves;
  cudaError_t err;
  if (n_shards <= 4 && entries <= 16) {
    err = launch_table<4, 16>(rows, n_shards, leaves, n_leaves, d, segs,
                              seg_groups, out, s);
  } else if (n_shards <= 16 && entries <= 64) {
    err = launch_table<16, 64>(rows, n_shards, leaves, n_leaves, d, segs,
                               seg_groups, out, s);
  } else if (n_shards <= 64 && entries <= 640) {
    err = launch_table<64, 640>(rows, n_shards, leaves, n_leaves, d, segs,
                                seg_groups, out, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

int fb_admm_update(const float* th, const float* la, const float* w,
                   float* lam_out, float* z_out, float* c_out, int64_t n,
                   int64_t d, int with_z, void* stream) {
  const int64_t total = n * d;
  return launch_admm_update<F32>(th, la, w, lam_out, z_out, c_out, total, d,
                                 grid_for(total), with_z,
                                 static_cast<cudaStream_t>(stream));
}

// `grid` blocks stride over c * tiles_per_slot tiles of 1024 columns;
// vec 2 (float2) where d is even and every base is 8-byte aligned, else 1.
int fb_fused_gss(const int32_t* idx, const bool* valid, const float* solved,
                 const float* w, float* th, float* la, float* z, int64_t c,
                 int64_t n, int64_t d, int grid, int64_t tiles_per_slot,
                 int vec, int with_z, void* stream) {
  return launch_fused_gss<F32>(idx, valid, solved, w, th, la, z, c, n, d,
                               grid, tiles_per_slot, vec, with_z, stream);
}

// K2a: bf16 arrays (as their 16 bits); vec 8 (admm_update_bf16x8_kernel)
// where every base is 16-byte aligned, else 1 (admm_update_kernel<BF16>).
int fb_admm_update_bf16(const unsigned short* th, const unsigned short* la,
                        const unsigned short* w, unsigned short* lam_out,
                        unsigned short* z_out, unsigned short* c_out,
                        int64_t n, int64_t d, int with_z, int vec,
                        void* stream) {
  const int64_t total = n * d;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec != 8) {
    return launch_admm_update<BF16>(th, la, w, lam_out, z_out, c_out, total,
                                    d, grid_for(total), with_z, s);
  }
  const int grid = grid_for((total + 7) / 8);
  if (with_z) {
    admm_update_bf16x8_kernel<true><<<grid, kThreads, 0, s>>>(
        th, la, w, lam_out, z_out, c_out, total, d);
  } else {
    admm_update_bf16x8_kernel<false><<<grid, kThreads, 0, s>>>(
        th, la, w, lam_out, z_out, c_out, total, d);
  }
  return static_cast<int>(cudaGetLastError());
}

// K3a: as fb_fused_gss on bf16 arrays; vec 2 (a 32-bit word of two bf16)
// where d is even and every base is 4-byte aligned, else 1.
int fb_fused_gss_bf16(const int32_t* idx, const bool* valid,
                      const unsigned short* solved, const unsigned short* w,
                      unsigned short* th, unsigned short* la,
                      unsigned short* z, int64_t c, int64_t n, int64_t d,
                      int grid, int64_t tiles_per_slot, int vec, int with_z,
                      void* stream) {
  return launch_fused_gss<BF16>(idx, valid, solved, w, th, la, z, c, n, d,
                                grid, tiles_per_slot, vec, with_z, stream);
}

}  // extern "C"
